"""The port's LM token pipeline (``repro_torch.data.lm``) against
``repro.data.lm``: seeded NumPy on both sides, so streams, windows and
batches are equal byte for byte."""
import itertools

import numpy as np
import pytest

from repro.data import lm as jlm
from repro_torch.data import lm as tlm


@pytest.mark.parametrize("vocab,n,seed", [(97, 2048, 0), (128_256, 5000, 3), (4096, 777, 11)])
def test_token_stream_bytes(vocab, n, seed):
    a, b = tlm.token_stream(vocab, n, seed=seed), jlm.token_stream(vocab, n, seed=seed)
    assert a.dtype == b.dtype == np.int32 and a.tobytes() == b.tobytes()


def test_token_windows_and_batches_bytes():
    stream = jlm.token_stream(512, 4000, seed=1)
    for n, seq, seed in ((8, 64, 0), (3, 512, 12)):
        a, b = tlm.token_windows(stream, n, seq, seed=seed), jlm.token_windows(stream, n, seq,
                                                                               seed=seed)
        assert a.shape == (n, seq) and a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="too short"):
        tlm.token_windows(stream[:10], 1, 16)
    for got, want in zip(itertools.islice(tlm.lm_batches(stream, 3, 32, seed=5), 4),
                         itertools.islice(jlm.lm_batches(stream, 3, 32, seed=5), 4)):
        assert got.keys() == want.keys()
        assert all(got[k].tobytes() == want[k].tobytes() for k in want)
