"""Port parity: burst_attn_tpu_torch.ops.ragged_paged (plain versions on
the CPU) against the JAX package's ragged kernel (interpret mode) and its
dense oracle, on the same numpy inputs, at tests/test_ragged_paged.py's
tolerances: 2e-6 in fp32, 1e-2 for int8 pools, 2e-6 for the split-k
partials."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.ops import paged_attention as jpa
from burst_attn_tpu.ops import ragged_paged as jrp
from burst_attn_tpu_torch.ops import paged_attention as pa
from burst_attn_tpu_torch.ops import ragged_paged as rp

TOL = dict(rtol=2e-6, atol=2e-6)


def _case(seed, *, slots=4, n_kv=2, group=2, page=128, width=3, n_pages=8,
          d=16, qt=6, quant=None):
    """tests/test_ragged_paged.py's mixed batch: slot 0 decodes, slot 1
    prefills a full chunk, slot 2 a short tail chunk, slot 3 is idle.
    numpy arrays; quantized pools come from the JAX quantizer."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((n_pages, n_kv, page, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, n_kv, page, d)).astype(np.float32)
    ks = vs = None
    if quant is not None:
        jdt = jpa.QUANT_DTYPES[quant][0]
        k, ks = (np.asarray(a) for a in jpa.quantize_tokens(k, dtype=jdt))
        v, vs = (np.asarray(a) for a in jpa.quantize_tokens(v, dtype=jdt))
    table = rng.integers(1, n_pages, size=(slots, width)).astype(np.int32)
    q_lens = np.asarray([1, qt, max(1, qt - 2), 0], np.int32)
    kv_lens = np.asarray([170, qt, 130 + max(1, qt - 2), 0], np.int32)
    q = rng.standard_normal((slots, n_kv * group, qt, d)).astype(np.float32)
    return dict(q=q, k_pages=k, v_pages=v, page_table=table, q_lens=q_lens,
                kv_lens=kv_lens, k_scales=ks, v_scales=vs)


def _to_torch(a):
    if a is None:
        return None
    if a.dtype.name == "float8_e4m3fn":  # ml_dtypes: reinterpret the bytes
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a, copy=True))


def _args(case, lib):
    conv = _to_torch if lib == "torch" else (
        lambda a: None if a is None else jnp.asarray(a))
    return {k: conv(v) for k, v in case.items()}


def _real(x, q_lens):
    """[S, Nq, QT, ...] -> rows of real query tokens only."""
    qt = x.shape[2]
    real = np.arange(qt)[None, :] < np.asarray(q_lens)[:, None]
    return np.moveaxis(np.asarray(x), 2, 1)[real]


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_quantize_tokens_bitwise(name):
    """The port's quantizer writes the same bytes and scales as JAX's,
    including rounding ties (int8 rounds half to even) and zero rows."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 3, 24, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0
    x[0, 1, 1, :] = np.arange(16) - 7.5   # scale 7.5/127: many ties
    x[1, 2, 5, :4] = [127.0, -127.0, 63.5, -0.5]
    jdt, tdt = jpa.QUANT_DTYPES[name][0], pa.QUANT_DTYPES[name][0]
    jq, js = jpa.quantize_tokens(jnp.asarray(x), dtype=jdt)
    q, s = pa.quantize_tokens(torch.from_numpy(x), dtype=tdt)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                  np.asarray(jq).view(np.uint8))


@pytest.mark.parametrize("kind", ["mixed", "gqa", "int8", "fp8"])
def test_ragged_matches_jax(kind):
    """Mixed, GQA and quantized batches: the port's plain version against
    the JAX kernel in interpret mode and the JAX oracle, on real rows;
    padding rows and the idle slot give zeros."""
    case = _case(2 if kind == "gqa" else 0,
                 **({"group": 4, "qt": 5} if kind == "gqa" else {}),
                 quant=kind if kind in ("int8", "fp8") else None)
    got = rp.ragged_paged_attention(**_args(case, "torch")).numpy()
    want = jrp.ragged_paged_attention(**_args(case, "jax"), interpret=True)
    oracle = jrp.ragged_paged_reference(**_args(case, "jax"))
    tol = TOL if kind in ("mixed", "gqa") else dict(atol=1e-2)
    for ref in (want, oracle):
        np.testing.assert_allclose(_real(got, case["q_lens"]),
                                   _real(ref, case["q_lens"]), **tol)
    qt = got.shape[2]
    pad = np.arange(qt)[None, :] >= case["q_lens"][:, None]
    assert (np.moveaxis(got, 2, 1)[pad] == 0).all()


def test_partials_with_ctx_lo_match_jax():
    """emit_partials + a page-aligned ctx_lo: the unnormalized fp32 acc and
    the base-2 (m, l) match the JAX kernel's split-k partials."""
    case = _case(3, quant=None)
    lo = np.asarray([128, 0, 128, 0], np.int32)
    got = rp.ragged_paged_attention(**_args(case, "torch"),
                                    ctx_lo=torch.from_numpy(lo),
                                    emit_partials=True)
    want = jrp.ragged_paged_attention(**_args(case, "jax"),
                                      ctx_lo=jnp.asarray(lo),
                                      emit_partials=True, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_real(g.numpy(), case["q_lens"]),
                                   _real(w, case["q_lens"]), **TOL)
    # base 2: m is the row max of scores * scale * log2(e)
    acc, m, l = got
    o = acc / torch.where(l > 0, l, 1.0)
    ref = rp.ragged_paged_reference(**_args(case, "torch"),
                                    ctx_lo=torch.from_numpy(lo))
    torch.testing.assert_close(o, ref, **TOL)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_grouped_matches_jax(quant):
    """Two slots share a one-page prefix group (its pages lead both table
    rows), one rides the null group: the grouped front end matches JAX's
    and the plain launch."""
    case = _case(4, quant=quant)
    case["page_table"][1, 0] = case["page_table"][2, 0]
    case["kv_lens"][1] = 128 + 6         # both past the shared page
    group_id = np.asarray([0, 1, 1, 0], np.int32)
    shared_table = np.asarray([[0, 0], [case["page_table"][1, 0], 0],
                               [0, 0]], np.int32)
    shared_lens = np.asarray([0, 128, 0], np.int32)
    grp = dict(group_id=group_id, shared_table=shared_table,
               shared_lens=shared_lens)
    got = rp.ragged_paged_attention_grouped(
        **_args(case, "torch"), **{k: torch.from_numpy(v)
                                   for k, v in grp.items()}).numpy()
    want = jrp.ragged_paged_attention_grouped(
        **_args(case, "jax"), **{k: jnp.asarray(v) for k, v in grp.items()},
        interpret=True)
    plain = rp.ragged_paged_attention(**_args(case, "torch")).numpy()
    # JAX's int8 shared band rounds p*scale to bf16; the port keeps fp32
    tol = TOL if quant is None else dict(atol=1e-2)
    for ref in (want, plain):
        np.testing.assert_allclose(_real(got, case["q_lens"]),
                                   _real(ref, case["q_lens"]), **tol)


def test_decode_rows_match_paged_decode():
    """QT == 1 through the ragged path equals paged decode (on the card
    the two kernels are bitwise equal; here the plain versions agree to
    fp32 rounding), and both match JAX's decode kernel."""
    rng = np.random.default_rng(4)
    slots, n_kv, group, page, d = 4, 2, 2, 128, 16
    kp = rng.standard_normal((8, n_kv, page, d)).astype(np.float32)
    vp = rng.standard_normal((8, n_kv, page, d)).astype(np.float32)
    table = rng.integers(1, 8, size=(slots, 3)).astype(np.int32)
    lengths = np.asarray([170, 1, 300, 0], np.int32)
    q = rng.standard_normal((slots, n_kv, group, d)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, kp, vp, table, lengths)]
    dec = pa.paged_decode_attention(*t)
    rag = rp.ragged_paged_attention(
        t[0].reshape(slots, n_kv * group, 1, d), t[1], t[2], t[3],
        (t[4] > 0).to(torch.int32), t[4])
    torch.testing.assert_close(rag.reshape(dec.shape), dec, **TOL)
    want = jpa.paged_decode_attention(*map(jnp.asarray, (q, kp, vp, table,
                                                         lengths)),
                                      interpret=True)
    np.testing.assert_allclose(dec.numpy(), np.asarray(want), **TOL)


def test_chunk_width_equals_sequential_chunks():
    """One 8-token chunk gives the rows of two 4-token chunks: a chunk
    boundary is invisible to the causal-within-slot mask."""
    rng = np.random.default_rng(3)
    n_kv, group, page, d = 2, 2, 128, 16
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (6, n_kv, page, d)).astype(np.float32)) for _ in range(2))
    table = torch.from_numpy(rng.integers(1, 6, size=(1, 2)).astype(
        np.int32))
    q = torch.from_numpy(rng.standard_normal((1, n_kv * group, 8, d)).astype(
        np.float32))

    def run(qq, ql, kl):
        return rp.ragged_paged_attention(
            qq, kp, vp, table, torch.tensor([ql], dtype=torch.int32),
            torch.tensor([kl], dtype=torch.int32))

    out8 = run(q, 8, 108)
    torch.testing.assert_close(out8[:, :, :4], run(q[:, :, :4], 4, 104),
                               **TOL)
    torch.testing.assert_close(out8[:, :, 4:], run(q[:, :, 4:], 4, 108),
                               **TOL)


def test_supported_probe_reasons_are_prefix_stable():
    """The probe states the CUDA kernel's limits with the prefixes the
    engine maps to fallback labels; on the CPU only the structural ones
    apply."""
    good = dict(n_kv_heads=2, n_q_heads=8, q_tokens=128, d_head=128,
                page=128, dtype=torch.bfloat16)
    assert rp.ragged_supported(**good) is None
    assert rp.ragged_supported(**{**good, "dtype": torch.float32}) is None
    bad = {
        "empty q chunk": dict(q_tokens=0),
        "GQA group mismatch": dict(n_q_heads=5),
        "page size": dict(page=100),
        "q-block rows": dict(n_q_heads=256, n_kv_heads=2),
        "shared-memory plan": dict(d_head=512),
        "head dim": dict(d_head=64),
        "dtype": dict(dtype=torch.float16),
    }
    for prefix, kw in bad.items():
        assert rp.ragged_supported(**{**good, **kw}).startswith(prefix)
    cpu = dict(good, device="cpu")
    assert rp.ragged_supported(**{**cpu, "d_head": 16}) is None
    assert rp.ragged_supported(**{**cpu, "page": 100}).startswith("page size")


def test_all_idle_batch_and_unported_window():
    case = _case(5, qt=4)
    case["q_lens"][:] = 0
    case["kv_lens"][:] = 0
    args = _args(case, "torch")
    out = rp.ragged_paged_attention(**args)
    assert out.shape == args["q"].shape and (out == 0).all()
    acc, m, l = rp.ragged_paged_attention(**args, emit_partials=True)
    assert (acc == 0).all() and torch.isneginf(m).all() and (l == 0).all()
    out = rp.ragged_paged_attention(**args, window=16)
    assert (out == 0).all()
    with pytest.raises(ValueError, match="window"):
        rp.ragged_paged_attention(**args, window=0)
