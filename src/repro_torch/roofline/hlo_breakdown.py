"""Per-op breakdown of a dry-run's op record, the dry-run's 'profiler', as
``repro.roofline.hlo_breakdown`` (which reads an XLA HLO dump): it ranks a
traced step's aten ops by result bytes and tallies them by opcode and the
collective traffic by op, telling what dominates the memory and
collective terms.

  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k --dump-ops /tmp/step.json
  python -m repro_torch.roofline.hlo_breakdown /tmp/step.json [--top 20]

The record (``--dump-ops``) is JSON: ``{"ops": [[name, opcode, result
bytes], ...], "collectives": [[op, result bytes, group size], ...]}``.
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict
from typing import Dict, List, Tuple


def parse_ops(record: dict) -> List[Tuple[str, str, int]]:
    """(name, opcode, result_bytes) of every op of the step."""
    return [(str(n), str(op), int(nb)) for n, op, nb in record.get("ops", [])]


def collective_bytes(record: dict) -> Dict[str, int]:
    """Result bytes per collective op over the step (unweighted)."""
    out: Dict[str, int] = defaultdict(int)
    for op, nb, *_ in record.get("collectives", []):
        out[op] += int(nb)
    return dict(out)


def breakdown(record: dict, top: int = 20) -> Dict:
    ops = parse_ops(record)
    by_opcode: Dict[str, int] = defaultdict(int)
    for _, opcode, nb in ops:
        by_opcode[opcode] += nb
    return {
        "by_opcode": dict(sorted(by_opcode.items(), key=lambda kv: -kv[1])),
        "biggest_instructions": sorted(ops, key=lambda o: -o[2])[:top],
        "n_ops": len(ops),
        "collectives": collective_bytes(record),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("record_path")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    with open(args.record_path) as f:
        record = json.load(f)
    rep = breakdown(record, args.top)
    print(f"ops: {rep['n_ops']}")
    print("\n== result bytes by opcode ==")
    for op, nb in list(rep["by_opcode"].items())[:25]:
        print(f"  {op:30s} {nb/1e9:10.3f} GB")
    print("\n== collectives (result bytes) ==")
    for op, nb in rep["collectives"].items():
        print(f"  {op:30s} {nb/1e9:10.3f} GB")
    print(f"\n== top {args.top} ops by result bytes ==")
    for name, opcode, nb in rep["biggest_instructions"]:
        print(f"  {nb/1e9:8.3f} GB  {opcode:24s} {name[:80]}")


if __name__ == "__main__":
    main()
