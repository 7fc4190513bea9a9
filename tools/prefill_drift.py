#!/usr/bin/env python3
"""How far a chain of prefill-megakernel layers drifts from the plain
chain: per layer, the hidden states' largest difference along the chain
and on the same input, and the pools' (int8 steps, or the bf16 largest
difference), at the card tests' small model-scope fixture.

    python3 tools/prefill_drift.py [--variant 'NAME:OLD=>NEW[@@OLD=>NEW]']

Run it from the root of the checkout whose kernel it measures (another
tree, e.g. a parent commit unpacked with ``git archive``, measures its
own kernel the same way). A variant is
``paddle_tpu_torch/kernels/csrc/prefill_megakernel.cu`` with each text
before ``=>`` replaced by the text after it, built beside the real source
for the run and deleted after. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

#: (heads, int8 pool) of the chains measured
CASES = [((8, 2, 64), True), ((8, 2, 64), False), ((4, 4, 128), True)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[])
    args = ap.parse_args()
    root = Path(os.getcwd())
    sys.path[:0] = [str(root), str(root / "tests")]
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import test_torch_cuda_kernels as t
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import prefill_megakernel as pmk

    src = (_build.CSRC / "prefill_megakernel.cu").read_text()
    sources, written = {"base": None}, []
    for spec in args.variant:
        name, edits = spec.split(":", 1)
        text = src
        for edit in edits.split("@@"):
            old, new = edit.split("=>", 1)
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in the "
                                 f"source")
            text = text.replace(old, new)
        path = _build.CSRC / f"prefill_megakernel_drift_{name}.cu"
        path.write_text(text)
        written.append(path)
        sources[name] = path.stem
    base = pmk._library()
    try:
        for name, stem in sources.items():
            if stem is not None:
                lib = _build.load(stem)
                for fn in ("prefill_megakernel", "prefill_megakernel_grid",
                           "prefill_megakernel_limits",
                           "prefill_megakernel_encode"):
                    getattr(lib, fn).argtypes = getattr(base, fn).argtypes
                    getattr(lib, fn).restype = getattr(base, fn).restype
                pmk._library = lambda lib=lib: lib
            else:
                pmk._library = lambda: base
            for heads, quant in CASES:
                chain(torch, t, pmk, f"{root.name} {name}", heads, quant)
    finally:
        pmk._library = lambda: base
        for path in written:
            path.unlink(missing_ok=True)
    return 0


def chain(torch, t, pmk, label, heads, quant):
    fused, h, pools, meta, kw = t._prefill_fixture(
        "cuda", torch.bfloat16, heads, quant_kv=quant, layers=3)
    pk, pp = t._clone_pools(pools), t._clone_pools(pools)
    hk = hp = h
    plain = dict(num_kv_heads=heads[1], head_dim=heads[2], page_size=16)
    for i, lyr in enumerate(fused):
        kp, vp, ks, vs = pk[i]
        hk2, kp, vp, ks, vs = pmk.fused_prefill_layer(
            lyr, hk, kp, vp, *meta, k_scales=ks, v_scales=vs, **kw)
        same = [x.clone() if x is not None else None for x in pp[i]]
        hs = pmk._reference_prefill_layer(
            lyr, hk, same[0], same[1], *meta, k_scales=same[2],
            v_scales=same[3], **plain, **kw)[0]
        k2, v2, ks2, vs2 = pp[i]
        hp2, k2, v2, ks2, vs2 = pmk._reference_prefill_layer(
            lyr, hp, k2, v2, *meta, k_scales=ks2, v_scales=vs2, **plain,
            **kw)
        torch.cuda.synchronize()
        pairs = ((kp, k2), (vp, v2))
        if quant:
            pools = max((a[:, 1:].int() - b[:, 1:].int()).abs().max().item()
                        for a, b in pairs)
            pools = f"{pools} int8 step(s)"
        else:
            pools = max((a[:, 1:].float() - b[:, 1:].float()).abs().max()
                        .item() for a, b in pairs)
            pools = f"{pools:.4e}"
        along = (hk2.float() - hp2.float()).abs().max().item()
        on_same = (hk2.float() - hs.float()).abs().max().item()
        print(f"{label}: heads {heads}, {'int8' if quant else 'bf16'} pool, "
              f"layer {i}: h along the chain {along:.4e}, on the same input "
              f"{on_same:.4e}; pools {pools}", flush=True)
        hk, hp = hk2, hp2


if __name__ == "__main__":
    sys.exit(main())
