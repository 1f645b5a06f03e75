"""Read the bf16 gradient noise floor that the smoke's mesh phase is held
against, on the card.

    python tools/mesh_grad_floor.py

run from the root of a checkout: builds the kernels, then takes one train
step of chip_smoke.py's mesh-phase model (the training model cut to
MESH_TRAIN_LAYERS layers, bf16, remat, B = dp rows of TRAIN_SEQ tokens,
the seed weights) on ONE device twice, on the same weights and batch:
through the kernels (flash forward, fused backward) and through plain
attention (autograd over the plain tile).  It prints both steps' loss and
grad norm and each gradient leaf's relative l2 difference between the two
routes, the spread two correct single-device routes show, as one line
`FLOOR {json}`.  Then it runs chip_smoke.mesh_train_phase, which prints the
dp x sp x tp step's differences from one device on the same inputs.
"""

import json
import os
import sys

sys.path.insert(0, os.getcwd())


def main() -> int:
    import torch

    import chip_smoke as cs
    from burst_attn_tpu_torch.models import train
    from burst_attn_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("mesh_grad_floor: no CUDA device is available", file=sys.stderr)
        return 2
    _build.build_all()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    full = cs._train_model(cs.TRAIN_DIMS["n_layers"], torch.bfloat16)
    tcfg = train.TrainConfig()
    cs._seed_state(full, tcfg, dev)
    key = (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
           full.d_ff, full.vocab, full.dtype)
    leaves = cs._SEED_PARAMS[key]
    per = len(leaves[1:-2]) // full.n_layers
    cut = leaves[:1 + per * cs.MESH_TRAIN_LAYERS] + leaves[-2:]
    cfg = cs._train_model(cs.MESH_TRAIN_LAYERS, torch.bfloat16)
    out = {}
    for route in ("kernels", "plain"):
        params = train.place_params(cs._params_like(cut, cfg), cfg)
        state = (params, train._optimizer(params, tcfg))
        step = train.make_train_step(cfg, tcfg, device=dev)
        batch = train.make_batch(1, cfg, batch=cs.MESH_TRAIN["dp"],
                                 seq=cs.TRAIN_SEQ, device=dev)
        if route == "plain":
            with cs.plain_train_attention():
                state, m = step(state, batch)
        else:
            state, m = step(state, batch)
        out[route] = (float(m["loss"]), float(m["grad_norm"]),
                      cs._whole_grads(params))
        del state, step, params
        torch.cuda.empty_cache()
    rel = {name: float((a.float() - b.float()).norm() / b.float().norm())
           for (name, a), (_, b) in zip(out["kernels"][2], out["plain"][2])}
    print("FLOOR " + json.dumps({
        "loss": [out["kernels"][0], out["plain"][0]],
        "grad_norm": [out["kernels"][1], out["plain"][1]],
        "grad_rel_l2": rel, "min": min(rel.values()),
        "max": max(rel.values())}), flush=True)
    del out
    torch.cuda.empty_cache()
    cs.mesh_train_phase(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
