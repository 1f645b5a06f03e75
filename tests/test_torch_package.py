"""Package rules of the PyTorch port: no JAX and nothing of the JAX
package on its import path, the card by default (no silent CPU
fallback), and the plain versions only for CPU tensors."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from burst_attn_tpu_torch.models import runner, train
from burst_attn_tpu_torch.models.paged_decode import init_paged_state
from burst_attn_tpu_torch.models.serve import ServeEngine
from burst_attn_tpu_torch.models.transformer import ModelConfig, init_params
from burst_attn_tpu_torch.ops import (
    flash, fused_ring, masks, paged_attention, ragged_paged, tile,
)
from burst_attn_tpu_torch.parallel import burst, schedule
from burst_attn_tpu_torch.parallel.mesh import Mesh
from burst_attn_tpu_torch.serving import RaggedServeEngine

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, importlib.util, pkgutil, sys
import burst_attn_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
spec = importlib.util.spec_from_file_location("fuzz_checkpoint",
                                              "tools/fuzz_checkpoint.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "burst_attn_tpu"))
ring = ["parallel.mesh", "parallel.ring", "parallel.schedule",
        "parallel.burst", "parallel.ulysses", "parallel.moe",
        "parallel.pipeline", "ops.fused_ring", "ops.tuning",
        "models.dist_decode", "models.pipeline_lm", "serving.handoff"]
bench = ["bench", "bench.step_probe"]
obs = ["obs", "obs.registry", "obs.logs", "obs.spans", "obs.trace",
       "obs.aggregate", "obs.__main__", "obs.devstats"]
serving_under_load = [
    "protocols.pool", "protocols.transport", "protocols.kvtransfer",
    "loadgen", "loadgen.trace", "loadgen.driver", "loadgen.slo",
    "loadgen.worker", "loadgen.cluster", "loadgen.__main__", "fleet",
    "fleet.transport", "fleet.kvplane", "fleet.policy", "fleet.fleet"]
analyzer = ["analysis", "analysis.core", "analysis.__main__",
            "analysis.astlint", "analysis.oracle", "analysis.ringcheck",
            "analysis.modelcheck", "analysis.protocheck",
            "analysis.poolcheck", "analysis.policycheck",
            "analysis.costmodel", "analysis.costcheck", "fleet.sim",
            "utils.testing", "analysis.opstream", "analysis.numerics",
            "analysis.obscheck", "analysis.servecheck"]
multiprocess = ["utils.multihost", "parallel.collectives"]
bad += [m for m in ring + bench + obs + serving_under_load + analyzer
        + multiprocess if pkg.__name__ + "." + m not in names]
print(len(names), bad)
"""


def test_import_pulls_in_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(maxsplit=1)
    assert int(n) >= 10  # every module was walked
    assert bad.strip() == "[]"


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA behaviour")
    cfg = ModelConfig(vocab=16, d_model=8, n_layers=1, n_heads=1,
                      n_kv_heads=1, d_head=8, d_ff=8, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_paged_state(cfg, slots=1, n_pages=2)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(params, cfg, slots=1, n_pages=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RaggedServeEngine(params, cfg, slots=1, n_pages=2)
    # the ring's mesh (burst_attn and the handoff take it) is on the card
    # unless asked for the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Mesh({"sp": 2})
    assert Mesh({"sp": 2}, device="cpu").device == torch.device("cpu")


def test_worker_specs_default_to_the_card():
    """A loadgen / fleet worker spec without "device" resolves to the
    card: without one the worker's build raises (its loop turns that into
    an "error" frame), it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA behaviour")
    from burst_attn_tpu_torch.loadgen import worker

    spec = dict(vocab=16, d_model=8, n_layers=1, n_heads=1, n_kv_heads=1,
                d_head=8, d_ff=8, seed=0)
    engine = dict(slots=1, n_pages=2, max_pages_per_seq=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.build_engine(spec, engine)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.model_from_spec(spec)
    eng = worker.build_engine(dict(spec, device="cpu"), engine)
    assert eng.device == torch.device("cpu")


_NO_ML_DTYPES = """
import sys
sys.modules["ml_dtypes"] = None
sys.modules["msgpack"] = None
import torch
from burst_attn_tpu_torch.fleet import kvplane, transport
page = {"k": [torch.ones(1, 128, 8, dtype=torch.bfloat16)],
        "v": [torch.ones(1, 128, 8).to(torch.float8_e4m3fn)]}
msg = transport.decode_message(transport.encode_message(page))
assert transport._msgpack is None
assert kvplane.page_digest(msg) == kvplane.page_digest(page)
print("ok")
"""


def test_fleet_wire_imports_without_ml_dtypes_or_msgpack():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_training_entry_points_default_to_the_card(tmp_path):
    """make_train_step, init_train_state, batch_from_host and fit raise
    without a card unless device="cpu" is asked for."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA behaviour")
    cfg = ModelConfig(vocab=16, d_model=8, n_layers=1, n_heads=1,
                      n_kv_heads=1, d_head=8, d_ff=8, dtype=torch.float32)
    tcfg = train.TrainConfig()
    x = np.zeros((1, 4), np.int32)
    for call in (lambda: train.make_train_step(cfg, tcfg),
                 lambda: train.init_train_state(0, cfg, tcfg),
                 lambda: train.batch_from_host(x, x, cfg),
                 lambda: runner.fit(cfg, tcfg, runner.RunConfig(
                     data_path=str(tmp_path / "none"), steps=1, batch=1,
                     seq_len=4))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    state = train.init_train_state(0, cfg, tcfg, device="cpu")
    _, metrics = train.make_train_step(cfg, tcfg, device="cpu")(
        state, train.batch_from_host(x, x, cfg, device="cpu"))
    assert torch.isfinite(metrics["loss"])


def test_cpu_tensors_take_the_plain_versions():
    """CPU tensors run the plain version and launch nothing; a tensor on
    any other non-CUDA device raises instead of falling back."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 40, 32, generator=g, device="cpu")
    k = torch.randn(1, 2, 40, 32, generator=g, device="cpu")
    counters = (flash.flash_fwd, paged_attention.paged_decode_attention,
                ragged_paged.ragged_paged_attention)
    before = [f.launches for f in counters]
    spec = masks.round_spec(0, 0, 40, 40, True, "contig")
    got = flash.flash_fwd(q, k, k, None, None, None, 0.5, spec)
    want = tile.tile_fwd(q, k, k, *tile.init_state(1, 4, 40, 32), 0.5, spec)
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    qd = torch.randn(2, 2, 2, 32, generator=g)
    pages = torch.randn(3, 2, 128, 32, generator=g)
    table = torch.tensor([[1], [2]], dtype=torch.int32)
    lengths = torch.tensor([5, 0], dtype=torch.int32)
    assert torch.equal(
        paged_attention.paged_decode_attention(qd, pages, pages, table,
                                               lengths),
        paged_attention.paged_decode_reference(qd, pages, pages, table,
                                               lengths))
    qr = qd.reshape(2, 4, 1, 32)
    q_lens = (lengths > 0).to(torch.int32)
    assert torch.equal(
        ragged_paged.ragged_paged_attention(qr, pages, pages, table, q_lens,
                                            lengths),
        ragged_paged.ragged_paged_reference(qr, pages, pages, table, q_lens,
                                            lengths))
    assert [f.launches for f in counters] == before
    bwd_before = dict(flash.flash_bwd.launches)
    delta = torch.zeros(1, 4, 40)
    got = flash.flash_bwd(q, q, k, k, delta, want[1], 0.5, spec)
    for a, b in zip(got, tile.tile_bwd(q, q, k, k, delta, want[1], 0.5,
                                       spec)):
        assert torch.equal(a, b)
    assert flash.flash_bwd.launches == bwd_before

    # the fused ring: the plain version walks the same program
    qs = torch.randn(2, 1, 2, 16, 32, generator=g)
    cfg = burst.BurstConfig(causal=True, layout="zigzag")
    before_fused = fused_ring.fused_ring_fwd.launches
    got = fused_ring.fused_ring_fwd(qs, qs, qs, cfg, 1, 2)
    prog = schedule.compile_fwd("uni", 2)
    tables = [fused_ring.build_sched_table(cfg, prog, 16, 16, p)[0]
              for p in range(2)]
    want = fused_ring.fused_ring_reference(qs, qs, qs, prog, tables,
                                           32 ** -0.5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert fused_ring.fused_ring_fwd.launches == before_fused
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_ring.fused_ring_fwd(qs.to("meta"), qs.to("meta"),
                                  qs.to("meta"), cfg, 1, 2)

    meta = q.to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash.flash_fwd(meta, k.to("meta"), k.to("meta"), None, None, None,
                        0.5, spec)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash.flash_bwd(meta, meta, k.to("meta"), k.to("meta"),
                        delta.to("meta"), delta.to("meta"), 0.5, spec)
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_attention.paged_decode_attention(
            qd.to("meta"), pages.to("meta"), pages.to("meta"),
            table.to("meta"), lengths.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ragged_paged.ragged_paged_attention(
            qr.to("meta"), pages.to("meta"), pages.to("meta"),
            table.to("meta"), q_lens.to("meta"), lengths.to("meta"))


def test_chip_smoke_refuses_without_the_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when no
    card is present, and also when run alone outside the repository."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA behaviour")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in [(ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")]:
        if cwd == tmp_path:
            script.write_bytes((ROOT / "chip_smoke.py").read_bytes())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_testing_helpers_match_jax():
    """utils/testing.py: check_close with the JAX helper's tolerances and
    NaN probe; random_qkv on an explicit generator and device."""
    from burst_attn_tpu.utils import testing as jt

    from burst_attn_tpu_torch.utils import testing as pt

    assert (pt.RTOL, pt.ATOL) == (jt.RTOL, jt.ATOL)
    a = np.linspace(-1, 1, 12, dtype=np.float32)
    for shift, ok in ((5e-3, True), (5e-2, False)):
        results = []
        for fn, x in ((jt.check_close, a + shift),
                      (pt.check_close, torch.from_numpy(a + shift))):
            try:
                fn(x, a)
                results.append(True)
            except AssertionError:
                results.append(False)
        assert results == [ok, ok]
    with pytest.raises(AssertionError, match="NaN"):
        pt.check_close(torch.tensor([float("nan")]), np.zeros(1))
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    q, k, v, do = pt.random_qkv(g1, 1, 4, 16, 8, kv_heads=2)
    assert q.shape == do.shape == (1, 4, 16, 8) and q.dtype == torch.bfloat16
    assert k.shape == v.shape == (1, 2, 16, 8)
    assert all(torch.equal(x, y) for x, y in
               zip((q, k, v, do), pt.random_qkv(g2, 1, 4, 16, 8, kv_heads=2)))
