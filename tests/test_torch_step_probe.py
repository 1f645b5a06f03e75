"""Port parity for kernel 10, the step-overhead probe
(burst_attn_tpu_torch.bench.step_probe): its plain version (CPU) against
the JAX probe's Pallas kernel in interpret mode on the same numpy inputs,
within 1e-5 of the largest entry; the fetch checksum against numpy; the
least-squares fit on noiseless synthetic rows; the CLI's refusal off the
card."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from burst_attn_tpu.utils.compat import tpu_compiler_params
from burst_attn_tpu_torch.bench import step_probe as sp

D = 128


def _jax_probe(q, kpool, n_steps, do_mm):
    """benchmarks/step_probe.py's pallas_call, rebuilt verbatim: `kernel`
    is a closure inside its main() (l.63-78), the call at l.95-109; only
    interpret=True is added, as the JAX package's own tests run Pallas on
    the CPU."""
    bq, d = q.shape[1], q.shape[2]
    bkv = kpool.shape[1]
    n_pool = kpool.shape[0]

    def kernel(q_ref, k_ref, o_ref, acc, *, do_mm):
        j = pl.program_id(0)

        @pl.when(j == 0)
        def _init():
            acc[:] = jnp.zeros_like(acc)

        if do_mm:
            w = min(acc.shape[1], k_ref.shape[1])  # static
            acc[:, :w] = acc[:, :w] + jax.lax.dot_general(
                q_ref[0, :, :], k_ref[0, :, :], (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )[:, :w]

        @pl.when(j == pl.num_programs(0) - 1)
        def _fin():
            o_ref[0, :, :] = acc[:]

    fn = pl.pallas_call(
        functools.partial(kernel, do_mm=do_mm),
        grid=(n_steps,),
        in_specs=[
            pl.BlockSpec((1, bq, d), lambda j: (0, 0, 0)),
            pl.BlockSpec((1, bkv, d),
                         lambda j, n_pool=n_pool: (j % n_pool, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, bq, 128), lambda j: (0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, bq, 128), jnp.float32),
        scratch_shapes=[pltpu.VMEM((bq, 128), jnp.float32)],
        compiler_params=tpu_compiler_params(
            dimension_semantics=("arbitrary",),
        ),
        interpret=True,
    )
    return np.asarray(fn(q, kpool))


def _inputs(seed, bq, bkv, steps):
    rng = np.random.default_rng(seed)
    n_pool = min(steps, 512)
    q = rng.standard_normal((1, bq, D), dtype=np.float32)
    pool = rng.standard_normal((n_pool, bkv, D), dtype=np.float32)
    # bf16 on both sides: the torch tensors carry the JAX arrays' bits
    jq, jpool = jnp.asarray(q, jnp.bfloat16), jnp.asarray(pool, jnp.bfloat16)
    tq = torch.from_numpy(q).bfloat16()
    tpool = torch.from_numpy(pool).bfloat16()
    np.testing.assert_array_equal(tq.float().numpy(),
                                  np.asarray(jq, np.float32))
    return jq, jpool, tq, tpool


@pytest.mark.parametrize("bkv,steps", [(32, 12), (256, 8)])
def test_plain_version_matches_jax_kernel(bkv, steps):
    jq, jpool, tq, tpool = _inputs(bkv, 64, bkv, steps)
    want = _jax_probe(jq, jpool, steps, True)
    before = sp.step_probe.launches
    got, sums = sp.step_probe(tq, tpool, steps)
    assert sp.step_probe.launches == before  # the CPU launches nothing
    top = float(np.abs(want).max())
    assert np.abs(got.numpy() - want).max() <= 1e-5 * top
    w = min(128, bkv)
    if w < 128:  # columns past the block's rows stay exactly zero
        assert (got[..., w:] == 0).all() and (want[..., w:] == 0).all()
    # without the matmul the output is zero, the fetch (and its sum) not
    none, sums0 = sp.step_probe(tq, tpool, steps, matmul=False)
    assert (none == 0).all() and (_jax_probe(jq, jpool, steps, False)
                                  == 0).all()
    assert torch.equal(sums, sums0)


@pytest.mark.parametrize("bq,bkv,steps", [(64, 32, 12), (40, 300, 700)])
def test_checksum_matches_numpy(bq, bkv, steps):
    """CTA c folds the 32-bit words of rows c, c + n_cta, ... of every
    block it fetches (pool[j % n_pool] for j < steps) into a wrapping
    32-bit sum."""
    _, _, tq, tpool = _inputs(1, bq, bkv, steps)
    _, sums = sp.step_probe(tq, tpool, steps, matmul=False)
    n_cta = sp.n_ctas(bq)
    assert sums.shape == (n_cta,)
    words = tpool.view(torch.int32).numpy().view(np.uint32)
    want = np.zeros(n_cta, np.uint64)
    n_pool = tpool.shape[0]
    for j in range(steps):
        blk = words[j % n_pool].astype(np.uint64)
        for c in range(n_cta):
            want[c] = (want[c] + blk[c::n_cta].sum()) % 2**32
    np.testing.assert_array_equal(sums.numpy(), want.astype(np.int64))


def test_fit_recovers_known_costs():
    t_fixed, bw, rate = 1.75, 2.5e12, 40e12
    rows = []
    for matmul in (True, False):
        for bkv in (256, 1024, 2048, 4096):
            for steps in (512, 2048, 8192):
                r = dict(bq=2048, bkv=bkv, steps=steps, matmul=matmul,
                         dim=D)
                r["us_per_step"] = (t_fixed + sp.step_bytes(r) / bw * 1e6
                                    + sp.step_flops(r) / rate * 1e6)
                rows.append(r)
    f = sp.fit(rows)
    assert f["t_fixed_us"] == pytest.approx(t_fixed, rel=1e-9)
    assert f["gb_per_s"] == pytest.approx(bw / 1e9, rel=1e-9)
    assert f["tflop_per_s"] == pytest.approx(rate / 1e12, rel=1e-9)
    assert max(map(abs, f["residuals_us"])) < 1e-9
    row = sp.cell_row(2048, 256, 512, D, True, 1.0, 512 * 256 * D * 2, "x")
    assert row["pool_fits_l2"] and row["us_per_step"] == 1e3 / 512
    assert not sp.cell_row(2048, 1024, 512, D, True, 1.0,
                           512 * 1024 * D * 2, "x")["pool_fits_l2"]


def test_cli_refuses_without_cuda(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "rows.jsonl"
    assert sp.main(["--out", str(out)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()


def test_wrapper_checks_its_operands():
    q = torch.zeros(1, 16, D, dtype=torch.bfloat16)
    pool = torch.zeros(2, 8, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        sp.step_probe(q.float(), pool, 2)
    with pytest.raises(ValueError, match="steps"):
        sp.step_probe(q, pool, 0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        sp.step_probe(q.to("meta"), pool.to("meta"), 2)
