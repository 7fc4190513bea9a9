#!/usr/bin/env python3
"""Time the port's ragged paged-attention kernel at the 7B step shapes
for several kv split counts and for edited copies of its CUDA source.

    python3 tools/ragged_variants.py [--splits 8,4,2] \\
        [--variant 'st3:constexpr int kStages = 2;=>constexpr int kStages = 3;']

A variant is ``paddle_tpu_torch/kernels/csrc/ragged_paged_attention.cu``
with the text before ``=>`` replaced by the text after it; it is built
beside the real source for the run and deleted after. Each (source,
split count) is timed by ``chip_smoke.time_ms`` (CUDA events, the L2
evicted) at the decode and prefill steps of ``chip_smoke``'s timing
phase over a bf16 and an int8 pool, beside the warm device time of the
split and merge launches (``chip_smoke.ragged_kernel_split``) and the
shared memory one block takes. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splits", default="8,4,2",
                    help="split counts, comma-separated")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME:OLD=>NEW, an edited copy of the source")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import paged_attention as tpa

    src = (_build.CSRC / "ragged_paged_attention.cu").read_text()
    sources = {"base": "ragged_paged_attention"}
    written = []
    for spec in args.variant:
        name, edit = spec.split(":", 1)
        old, new = edit.split("=>", 1)
        if old not in src:
            raise SystemExit(f"variant {name}: {old!r} is not in the source")
        path = _build.CSRC / f"ragged_variant_{name}.cu"
        path.write_text(src.replace(old, new))
        written.append(path)
        sources[name] = path.stem
    try:
        _build.build(list(sources.values()))
        base = tpa._library()
        libs = {}
        for name, stem in sources.items():
            lib = _build.load(stem)
            for fn in ("ragged_paged_attention",
                       "ragged_paged_attention_int8",
                       "ragged_paged_attention_merge",
                       "ragged_paged_attention_smem_bytes",
                       "ragged_paged_attention_last_body"):
                getattr(lib, fn).argtypes = getattr(base, fn).argtypes
                getattr(lib, fn).restype = getattr(base, fn).restype
            libs[name] = lib
        print(cs.card_line(), flush=True)
        for name, lib in libs.items():
            smem = lib.ragged_paged_attention_smem_bytes
            print(f"{name}: {smem(1, 0, 8, 128)} B (bf16 pool), "
                  f"{smem(1, 1, 8, 128)} B (int8 pool) of shared memory per "
                  f"block at 8 rows, d 128", flush=True)
        time_all(torch, cs, tpa, libs,
                 [int(x) for x in args.splits.split(",")])
    finally:
        for path in written:
            path.unlink(missing_ok=True)
    return 0


def time_all(torch, cs, tpa, libs, splits):
    geo = dict(hq=32, hkv=32, d=128, ps=16)
    shapes = {
        "decode": [(1, n) for n in (49, 128, 233, 350, 441, 512, 560, 632)],
        "prefill": [(64, 600)] + [(1, n) for n in (49, 128, 233, 350, 441,
                                                  512, 560)],
    }
    library, target, most = tpa._library, tpa._TARGET_SLOTS, tpa._MAX_SPLITS
    try:
        for label, rows in shapes.items():
            q, k, v, tables, qs, ql, kl = cs.ragged_inputs(
                torch, rows, num_pages=513, pps=64, q_block=8, t_total=128,
                dtype=torch.bfloat16, seed=11, **geo)
            kq, ks, vq, vs = cs.quantize_pools(torch, k, v)
            meta = (tables, qs, ql, kl)
            for pool in ("bf16", "int8"):
                kv, sc = ((k, v), {}) if pool == "bf16" else \
                    ((kq, vq), dict(k_scales=ks, v_scales=vs))
                want = tpa.ragged_paged_attention_reference(
                    q, *kv, *meta, **sc).float()
                for name, lib in libs.items():
                    for n in splits:
                        # the wrapper takes min(n, a row's tiles) splits
                        tpa._library = lambda lib=lib: lib
                        tpa._TARGET_SLOTS, tpa._MAX_SPLITS = 1 << 30, n
                        call = lambda: tpa.ragged_paged_attention(  # noqa
                            q, *kv, *meta, q_block=8, **sc)
                        err = (call().float() - want).abs().max().item()
                        if err > cs.ATOL["bfloat16"]:
                            raise AssertionError(f"{name} {n}: {err}")
                        ms = cs.time_ms(torch, call, 100)
                        split_ms, merge_ms = cs.ragged_kernel_split(torch,
                                                                    call)
                        print(f"{label} {pool} {name} splits {n}: {ms:.4f} ms "
                              f"(L2 evicted); warm split {split_ms:.4f}, "
                              f"merge {merge_ms:.4f}; max|diff| {err:.2e}",
                              flush=True)
    finally:
        tpa._library, tpa._TARGET_SLOTS, tpa._MAX_SPLITS = \
            library, target, most


if __name__ == "__main__":
    sys.exit(main())
