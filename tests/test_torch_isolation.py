"""The port stands alone: every module of ``repro_torch`` and
``chip_smoke.py`` imports with ``jax``, ``repro`` and ``ml_dtypes`` blocked,
the bridge carries bfloat16 bits with them blocked, and the smoke script
refuses to run without a CUDA card."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}

BLOCKED_IMPORTS = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "repro", "ml_dtypes"):
    sys.modules[name] = None  # any import of them, or below them, now fails
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
# the training path's, the queue engines', FedAvg's and the audit's modules
# (and the two deprecated shims), the LM workload's, the mesh and sharding
# layer's, and the step builders', the dry-run's and the roofline's, among them
assert {"repro_torch.common.tree", "repro_torch.optim.optimizers", "repro_torch.optim.schedule",
        "repro_torch.core.trainer", "repro_torch.core.session", "repro_torch.core.faults",
        "repro_torch.core.protocol", "repro_torch.core.queue", "repro_torch.core.fedavg",
        "repro_torch.privacy.audit", "repro_torch.core.dp",
        "repro_torch.core.inversion", "repro_torch.models.attention",
        "repro_torch.models.transformer", "repro_torch.models.model", "repro_torch.data.lm",
        "repro_torch.models.moe", "repro_torch.models.ssm",
        "repro_torch.core.distributed", "repro_torch.launch.serve",
        "repro_torch.launch.train", "repro_torch.launch.mesh", "repro_torch.sharding.logical",
        "repro_torch.sharding.specs", "repro_torch.sharding.collectives",
        "repro_torch.sharding.tensor_parallel", "repro_torch.launch.steps",
        "repro_torch.launch.dryrun", "repro_torch.roofline.analysis",
        "repro_torch.roofline.hlo_breakdown"} <= set(names), names
import numpy as np, torch
from repro_torch.common.bridge import to_numpy, to_torch
bits = np.array([0x3F80, 0x7FC1, 0x8000], np.uint16)
t = to_torch({"a": bits.view("V2")}, "cpu")["a"]
assert t.dtype == torch.bfloat16 and t.view(torch.int16).numpy().view(np.uint16).tolist() == bits.tolist()
back = to_numpy({"a": t})["a"]
assert back.dtype == np.dtype("V2") and back.tobytes() == bits.tobytes()
sys.path.insert(0, sys.argv[1])
import chip_smoke
loaded = [m for m, v in sys.modules.items() if v is not None
          and (m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))]
assert not loaded, loaded
print(len(names))
"""


def test_port_imports_without_jax_or_repro():
    out = subprocess.run([sys.executable, "-c", BLOCKED_IMPORTS, REPO], env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 76  # every module was walked


def test_chip_smoke_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        return  # nothing to refuse here; the script runs on the card instead
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], env=ENV,
                         capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
