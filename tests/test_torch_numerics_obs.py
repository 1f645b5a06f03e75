"""The port's numerics, obscheck and servecheck families (the analyzer's
last seven JAX rules, recorded as op streams) on the CPU: each JAX seeded
mutation of tests/test_analysis.py has a port counterpart firing under
the same rule name, and each has its quiet case.  The card halves (the
kernels' SASS, sync-debug runs, CUDA-graph captures) are in
tests/test_torch_cuda.py."""

import os
import shutil

import pytest
import torch

from burst_attn_tpu.analysis import core as jax_core
from burst_attn_tpu.analysis import numerics as jax_numerics  # noqa: F401
from burst_attn_tpu.analysis import obscheck as jax_obscheck  # noqa: F401
from burst_attn_tpu.analysis import servecheck as jax_servecheck  # noqa: F401

from burst_attn_tpu_torch.analysis import numerics, obscheck, opstream
from burst_attn_tpu_torch.analysis import servecheck
from burst_attn_tpu_torch.analysis.core import RULES, register_all
from burst_attn_tpu_torch.ops import ragged_paged, tile
from burst_attn_tpu_torch.ops.masks import round_spec
from burst_attn_tpu_torch.parallel import burst, mesh
from burst_attn_tpu_torch.serving import model as sm

ANCHOR = ("seeded.py", 7)
NEW_RULES = ("fp32-accum", "lse-fp32", "devstats-pure", "ckpt-jit-safe",
             "pipe-fused-pure", "pipe-tick-identity", "ragged-serve-safe")

register_all()


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny shapes: one intra-op thread (with JAX in the process, torch's
    default pool ran these ops several times slower)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rules_of(findings):
    return {f.rule for f in findings}


def test_the_seven_rules_are_registered_under_the_jax_names():
    for name in NEW_RULES:
        assert name in RULES and name in jax_core.RULES
        assert RULES[name].kind == "trace"


# ---------------------------------------------------------------------------
# the recorder


def test_recorder_flags_host_reads_shapes_copies_and_collectives():
    x = torch.arange(6.0)
    with opstream.record() as st:
        x.sum().item()
        x.tolist()
        x[x > 2]
        x.to(torch.bfloat16)
        mesh.ppermute([(torch.zeros(2),), (torch.zeros(2),)], "intra", 1, 2)
    assert [e.op for e in st.host_reads()] == [
        "aten._local_scalar_dense", "tensor.tolist"]
    assert [e.op for e in st.data_dependent()] == ["aten.index"]
    assert [e.collective for e in st.collectives()] == [("pay", "intra", 1)]
    assert st.cross_device() == []
    assert torch.Tensor.tolist.__name__ == "tolist"  # restored on exit
    with opstream.record() as st2:
        pass
    assert st2 == []


def test_stream_signature_holds_scalars_nan_equal():
    x = torch.zeros(3)
    with opstream.record() as a:
        x.masked_fill(x > 0, float("nan")) * 2.0
    with opstream.record() as b:
        x.masked_fill(x > 0, float("nan")) * 2.0
    with opstream.record() as c:
        x.masked_fill(x > 0, float("nan")) * 3.0
    assert a.signatures() == b.signatures() != c.signatures()


# ---------------------------------------------------------------------------
# numerics (fp32-accum, lse-fp32)


def _tile_fwd_bf16_accum(q, k, v, m, lse, acc, scale, spec):
    """tile_fwd with its products kept in bf16 (no upcast): the mutation."""
    s = torch.einsum("bnid,bnjd->bnij", q, k) * scale
    p = torch.softmax(s.float(), -1).to(q.dtype)
    return torch.einsum("bnij,bnjd->bnid", p, v)


def _plain_case(fn):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 128, 64, generator=g).to(torch.bfloat16)
               for _ in range(3))
    f3 = torch.zeros(1, 2, 128)
    spec = round_spec(0, 0, 128, 128, True, "contig")
    return [("seeded tile_fwd", fn,
             lambda: fn(q, k, v, f3 - float("inf"), f3,
                        torch.zeros(1, 2, 128, 64), 0.125, spec))]


@pytest.mark.parametrize("fn,fires", [(_tile_fwd_bf16_accum, True),
                                      (tile.tile_fwd, False)],
                         ids=["bf16-accumulating", "real"])
def test_bf16_accumulating_tile_fwd_fires(fn, fires):
    findings = numerics.check_plain_versions(_plain_case(fn))
    assert _rules_of(findings) == ({"fp32-accum"} if fires else set())


@pytest.mark.parametrize("cast,fires", [(torch.bfloat16, True),
                                        (torch.float32, False)])
def test_lse_downcast_fires(cast, fires):
    lse = torch.zeros(1, 2, 64)
    with opstream.record() as st:
        lse.to(cast) * 1
    findings = numerics.check_stream(st, where="seeded", anchor=ANCHOR)
    assert _rules_of(findings) == ({"lse-fp32"} if fires else set())
    if fires:
        assert findings[0].file == "seeded.py" and findings[0].line == 7


def _csrc_copy(tmp_path, name, old, new):
    dst = tmp_path / "csrc"
    shutil.copytree(numerics.CSRC, dst)
    p = dst / name
    src = p.read_text()
    assert old in src
    p.write_text(src.replace(old, new, 1))
    return str(dst)


def test_sources_clean_on_the_port():
    assert numerics.check_sources() == []


def test_f16_accumulator_string_in_mma_tile_fires(tmp_path):
    root = _csrc_copy(tmp_path, "mma_tile.cuh",
                      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                      "mma.sync.aligned.m16n8k16.row.col.f16.f16.f16.f16")
    findings = numerics.check_sources(root)
    assert _rules_of(findings) == {"fp32-accum"}
    assert findings[0].file.endswith("mma_tile.cuh")


def test_bf16_stats_parameter_fires(tmp_path):
    root = _csrc_copy(tmp_path, "flash_fwd.cu",
                      "const float* __restrict__ lse_in",
                      "const __nv_bfloat16* __restrict__ lse_in")
    assert _rules_of(numerics.check_sources(root)) == {"lse-fp32"}


def test_sass_census_reads_the_accumulator_type():
    sass = ("\tFunction : _Zgood\n"
            "  /*0010*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n"
            "  /*0020*/  HFMA2.MMA R1, -RZ, RZ, 0, 0 ;\n"
            "\tFunction : _Zbad\n"
            "  /*0010*/  HMMA.16816.F16 R4, R8, R12, R4 ;\n")
    findings = numerics.check_sass_text("lib", sass, need_mma=True)
    assert _rules_of(findings) == {"fp32-accum"}
    assert "_Zbad" in findings[0].message
    assert numerics.check_sass_text("lib", sass, need_mma=True,
                                    match="_Zgood") == []
    # a library with tensor-core instances and no HMMA in its census fails
    assert numerics.check_sass_text("lib", "", need_mma=True)
    assert numerics.check_sass_text("lib", "", need_mma=False) == []


# ---------------------------------------------------------------------------
# obscheck (obs-jit-safe's dynamic half, devstats-pure, ckpt-jit-safe,
# pipe-fused-pure, pipe-tick-identity)


def _item_entry(*a, **k):
    out = burst.burst_attn(*a, **k)
    (out[0] if k.get("collect_stats") else out).float().sum().item()
    return out


def _leaky_entry(*a, **k):
    """burst_attn with one extra op on its stats-off path."""
    out = burst.burst_attn(*a, **k)
    return out if k.get("collect_stats") else out * 1


@pytest.mark.parametrize("entry,want", [
    (None, set()),
    (_item_entry, {"obs-jit-safe", "devstats-pure"}),
    (_leaky_entry, {"devstats-pure"})], ids=["real", "item", "stats-off-op"])
def test_ring_purity_mutations_fire(entry, want):
    findings = obscheck.check_ring_purity("cpu", entry=entry,
                                          backends=("jnp",))
    assert _rules_of(findings) == want, [f.format() for f in findings]


def test_off_identity_detects_one_extra_op():
    x = torch.ones(4)
    with opstream.record() as plain:
        x * 2
    with opstream.record() as same:
        x * 2
    with opstream.record() as leaky:
        x * 2 + 1
    assert obscheck.check_off_identity(same, plain, anchor=ANCHOR) == []
    findings = obscheck.check_off_identity(leaky, plain, anchor=ANCHOR)
    assert _rules_of(findings) == {"devstats-pure"}
    assert findings[0].file == "seeded.py" and findings[0].line == 7


def _with_item(fn):
    def step(*a, **k):
        out = fn(*a, **k)
        out[0].sum().item()  # a host read inside the step
        return out
    return step


def test_item_in_a_serve_step_fires_ckpt(monkeypatch):
    monkeypatch.setattr(sm, "ragged_model_step",
                        _with_item(sm.ragged_model_step))
    findings = obscheck.check_serve_steps("cpu")
    assert "ckpt-jit-safe" in _rules_of(findings)
    assert {f.message.split(":")[0] for f in findings
            if f.rule == "ckpt-jit-safe"} == {
        "ragged_model_step (attn=dense)", "ragged_model_step (attn=ragged)"}


def test_item_in_the_fused_decode_fires_pipe_fused(monkeypatch):
    monkeypatch.setattr(sm, "pipelined_tick", _with_item(sm.pipelined_tick))
    findings = obscheck.check_serve_steps("cpu")
    assert "pipe-fused-pure" in _rules_of(findings)
    assert all(f.rule in ("pipe-fused-pure", "pipe-tick-identity")
               for f in findings)


def test_collective_in_the_fused_decode_fires_pipe_fused(monkeypatch):
    real = sm.pipelined_tick

    def tick(*a, **k):
        choice, state = real(*a, **k)
        mesh.all_reduce([choice.float(), choice.float()], "sum", axis="tp")
        return choice, state

    monkeypatch.setattr(sm, "pipelined_tick", tick)
    params, cfg = obscheck.serve_setup("cpu")
    with opstream.record() as st:
        sm.multi_step_decode(params, torch.zeros(2, dtype=torch.long),
                             torch.ones(2, dtype=torch.int32),
                             obscheck.fresh_state(cfg, "cpu"), None, cfg,
                             k=4)
    findings = obscheck.check_collective_free(st, where="seeded decode",
                                              anchor=ANCHOR)
    assert _rules_of(findings) == {"pipe-fused-pure"} and len(findings) == 4
    assert "collective" in findings[0].message


def test_real_serve_steps_are_quiet():
    assert obscheck.check_serve_steps("cpu") == []


def _diverging_body(params, toks, q_lens, state, rng, cfg, k, attn,
                    temperature, top_k, top_p):
    """_decode_ticks with the logits scaled before sampling."""
    outs = []
    for _ in range(k):
        logits, _ = sm.ragged_model_step(params, toks[:, None], q_lens,
                                         state, cfg, attn=attn)
        toks = sm.sample_logits(logits * 1.0, rng, temperature=temperature,
                                top_k=top_k, top_p=top_p, nan_sentinel=True)
        outs.append(toks)
    return torch.stack(outs)


@pytest.mark.parametrize("body,fires", [(_diverging_body, True),
                                        (None, False)],
                         ids=["diverging", "real"])
def test_k1_body_identity(body, fires):
    params, cfg = obscheck.serve_setup("cpu")
    findings = obscheck.check_tick_identity(params, cfg, "cpu", body=body)
    assert _rules_of(findings) == ({"pipe-tick-identity"} if fires
                                   else set())
    if fires:
        assert len(findings) == 2  # greedy and sampled


# ---------------------------------------------------------------------------
# servecheck (ragged-serve-safe)


def _fake_ragged(hook):
    real = ragged_paged.ragged_paged_attention

    def launch(q, kp, vp, table, q_lens, kv_lens, **kw):
        hook(q_lens)
        return real(q, kp, vp, table, q_lens, kv_lens, **kw)

    return launch


@pytest.mark.parametrize("hook,needle", [
    (lambda lens: lens.sum().item(), "reads a tensor's values"),
    (lambda lens: int(lens[0]), "reads a tensor's values"),
    (lambda lens: lens[lens > 0], "data-dependent shape"),
    (lambda lens: mesh.all_to_all([lens, lens], 0, 0, axis="sp"),
     "census")], ids=["item", "int", "bool-index", "collective"])
def test_servecheck_mutations_fire(monkeypatch, hook, needle):
    monkeypatch.setattr(ragged_paged, "ragged_paged_attention",
                        _fake_ragged(hook))
    findings = servecheck.check_all()
    assert _rules_of(findings) == {"ragged-serve-safe"}
    assert len(findings) == 3  # every engine width fires
    assert all(needle in f.message for f in findings), [
        f.format() for f in findings]


def test_servecheck_launch_failure_fires(monkeypatch):
    def broken(*a, **k):
        raise ValueError("q_lens must be a host list")

    monkeypatch.setattr(ragged_paged, "ragged_paged_attention", broken)
    findings = servecheck.check_all()
    assert len(findings) == 3
    assert all("not safe" in f.message for f in findings)


def test_servecheck_quiet_on_the_port():
    assert servecheck.check_all() == []


def test_sources_are_the_kernel_sources():
    names = sorted(os.listdir(numerics.CSRC))
    assert "mma_tile.cuh" in names and "ragged_paged.cu" in names
