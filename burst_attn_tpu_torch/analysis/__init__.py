"""burstlint for the PyTorch port (port of burst_attn_tpu/analysis): static
and host-driven verification of the port's ring, serving-protocol,
pool and cost contracts, with an H100 cost model.

Families (each a module here, registered in core.RULES):

  * astlint      AST rules over the package source: silent exception
                 swallowing, hard mesh.shape[axis] indexing, and host
                 syncs / clock reads / tensor branches / obs calls inside
                 a function that a CUDA graph capture runs;
  * ringcheck    the scan ring's rotations, recorded by parallel/mesh.py
                 while the real forward and backward run on the CPU, held
                 to the independent schedule oracle (oracle.py); the
                 compiled ring programs (parallel/schedule.py) proven by
                 simulation; on the card, the fused route's zero
                 rotations and its kernels' launches;
  * protocheck   the serving protocols model-checked (modelcheck.py) over
                 the port's own machines (protocols/);
  * poolcheck    the copy-on-write barrier and the quantized pool's
                 (page, scale) pairs, driven on a tiny engine;
  * costcheck    the shared-memory plans, the cost model's identities and
                 the tuning defaults (costmodel.py); on the card, the
                 plans against the compiled kernels;
  * policycheck  fleet/policy.py is provably pure.

CLI: python -m burst_attn_tpu_torch.analysis [--json] [--card] ...
"""

from .core import Finding, Rule, RULES, rule, run_analysis  # noqa: F401
