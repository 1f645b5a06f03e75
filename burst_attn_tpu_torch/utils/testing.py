"""Test helpers (port of burst_attn_tpu/utils/testing.py): the reference's
numeric checker (test/checker.py) rebuilt.

check_close keeps the reference's tolerance convention (rtol=1e-3, atol=1e-2
in half precision, test/checker.py:10) and its NaN probe (checker.py:21).
random_qkv draws from an explicit torch.Generator on an explicit device,
so a test's tensors never depend on the global RNG's state.
"""

import numpy as np
import torch

RTOL = 1e-3
ATOL = 1e-2


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def check_close(a, b, rtol=RTOL, atol=ATOL, msg=""):
    a, b = _np32(a), _np32(b)
    assert not np.isnan(a).any(), f"NaN in actual {msg}"
    assert not np.isnan(b).any(), f"NaN in expected {msg}"
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=msg)


def random_qkv(generator: torch.Generator, batch, heads, seq, dim,
               kv_heads=None, dtype=torch.bfloat16, device="cpu"):
    """(q, k, v, do) of standard normals from `generator` on `device`:
    q and do [batch, heads, seq, dim], k and v [batch, kv_heads, seq,
    dim] (kv_heads defaults to heads)."""
    kv_heads = kv_heads or heads

    def draw(h):
        return torch.randn((batch, h, seq, dim), generator=generator,
                           device=device, dtype=torch.float32).to(dtype)

    return draw(heads), draw(kv_heads), draw(kv_heads), draw(heads)
