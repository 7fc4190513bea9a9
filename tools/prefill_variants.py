#!/usr/bin/env python3
"""Time the port's prefill megakernel at one full-width Llama-2-7B layer
over the T = 128 mixed step for edited copies of its CUDA source.

    python3 tools/prefill_variants.py [--presets] \\
        [--variant 'NAME:OLD=>NEW[@@OLD=>NEW]'] [--json PATH]

A variant is ``paddle_tpu_torch/kernels/csrc/prefill_megakernel.cu`` with
each text before ``=>`` replaced by the text after it; it is built beside
the real source for the run and deleted after. ``--presets`` adds the
knobs the design left open: the projection ring's bytes (its depth), the
cluster that splits K of o and down (1, 2, 4), attention units of one q
block or two per m16 tile, the warps splitting a unit's horizon (1, 2,
4) and their cp.async ring's depth, the bf16 parts P is fed to P.V in
(1, 2, 3) and the V slices of a P.V batch, and the K steps of a wgmma
group. Each source is held against the plain
version (``chip_smoke.mega_err``; one that fails it is reported and timed
all the same) and timed by ``chip_smoke.time_ms``
(CUDA events, the L2 evicted) at the bf16 layer and the int8 w + int8
pool layer of ``chip_smoke``'s timing phase, beside its phase stamps (10
launches, L2 warm) and its registers and spills. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PRESETS = {
    "ring160k": "constexpr int kRingBytes = 196608;=>"
                "constexpr int kRingBytes = 163840;",
    "cluster1": "constexpr int kCluster = 2;=>constexpr int kCluster = 1;",
    "cluster4": "constexpr int kCluster = 2;=>constexpr int kCluster = 4;",
    "one_qblock": "constexpr bool kPairBlocks = true;=>"
                  "constexpr bool kPairBlocks = false;",
    "attn_nosplit": "constexpr int kAttnSplit = 2;=>"
                    "constexpr int kAttnSplit = 1;",
    "attn_split4": "constexpr int kAttnSplit = 2;=>"
                   "constexpr int kAttnSplit = 4;",
    "attn_4warps_5stages": "constexpr int kAttnWarps = 8;=>"
                           "constexpr int kAttnWarps = 4;@@"
                           "constexpr int kAttnSplit = 2;=>"
                           "constexpr int kAttnSplit = 1;@@"
                           "constexpr int kAttnStages = 2;=>"
                           "constexpr int kAttnStages = 5;",
    "pv4slices": "constexpr int kPVSlices = 2;=>"
                 "constexpr int kPVSlices = 4;",
    "p1part": "constexpr int kPParts = 3;=>constexpr int kPParts = 1;",
    "p2parts": "constexpr int kPParts = 3;=>constexpr int kPParts = 2;",
    "gu_2steps": "constexpr int KPG = NT == 2 ? 1 : 2;=>"
                 "constexpr int KPG = 2;",
    "kpg1": "constexpr int KPG = NT == 2 ? 1 : 2;=>constexpr int KPG = 1;",
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--presets", action="store_true",
                    help="time the preset variants too")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME:OLD=>NEW[@@OLD=>NEW], an edited copy of the "
                         "source")
    ap.add_argument("--json", help="write the rows here")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import decode_megakernel as dmk
    from paddle_tpu_torch.kernels import prefill_megakernel as pmk

    specs = list(args.variant)
    if args.presets:
        specs += [f"{k}:{v}" for k, v in PRESETS.items()]
    src = (_build.CSRC / "prefill_megakernel.cu").read_text()
    sources, written = {"base": "prefill_megakernel"}, []
    for spec in specs:
        name, edits = spec.split(":", 1)
        text = src
        for edit in edits.split("@@"):
            old, new = edit.split("=>", 1)
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in the "
                                 f"source")
            text = text.replace(old, new)
        path = _build.CSRC / f"prefill_megakernel_variant_{name}.cu"
        path.write_text(text)
        written.append(path)
        sources[name] = path.stem
    base = pmk._library()
    rows = []
    try:
        print(cs.card_line(), flush=True)
        print(f"built in {_build.build(list(sources.values())):.2f} s",
              flush=True)
        libs = {}
        for name, stem in sources.items():
            lib = _build.load(stem)
            for fn in ("prefill_megakernel", "prefill_megakernel_grid",
                       "prefill_megakernel_limits",
                       "prefill_megakernel_encode"):
                getattr(lib, fn).argtypes = getattr(base, fn).argtypes
                getattr(lib, fn).restype = getattr(base, fn).restype
            libs[name] = lib
            cs.report_prefill_build(_build, stem, strict=False)
        rows = run(torch, cs, dmk, pmk, libs)
    finally:
        pmk._library = lambda: base
        dmk._GRIDS.clear()
        for path in written:
            path.unlink(missing_ok=True)
    if args.json:
        Path(args.json).write_text(json.dumps(rows, indent=1))
    return 0


def run(torch, cs, dmk, pmk, libs):
    from paddle_tpu_torch.serving.engine import _chunk_append_fn
    kw = dict(eps=1e-5, num_heads=32, q_block=8)
    rows = []
    for label, quant in (("bf16", False), ("int8 w + int8 pool", True)):
        fused = pmk.fuse_layer_weights(cs.mega_layers(torch, 1, quant,
                                                      seed=51)[0])
        h, pool, m, append = cs.prefill_inputs(torch, quant, seed=52)
        kp, vp, ks, vs = pool
        meta = (m["tbl"], m["pre"], m["q_starts"], m["q_lens"], m["kv_lens"])
        def fresh():
            """Copies of the pools and, for int8, their scales (the append
            updates both)."""
            c = [x.clone() if x is not None else None for x in pool]
            return (c[0], c[1], dict(k_scales=c[2], v_scales=c[3],
                                     quant_append_fn=_chunk_append_fn(append))
                    if quant else {})

        k0, v0, kw_kv = fresh()
        want = pmk._reference_prefill_layer(
            fused, h, k0, v0, *meta, num_kv_heads=32, head_dim=128,
            page_size=cs.PAGE, **kw, **kw_kv)[0]
        for name, lib in libs.items():
            pmk._library = lambda lib=lib: lib
            dmk._GRIDS.clear()
            k0, v0, kw_kv = fresh()
            got = pmk.fused_prefill_layer(fused, h, k0, v0, *meta, **kw,
                                          **kw_kv)[0]
            try:
                err, tol = cs.mega_err(torch, got, want, f"variant {name}")
            except AssertionError as e:     # timed all the same, not held
                print(f"{label} {name}: FAILS parity: {e}", flush=True)
                err = tol = float("nan")
            kern = lambda: pmk._launch_cuda(      # noqa: E731
                fused, h, kp, vp, ks, vs, *meta, **kw)
            ms = cs.time_ms(torch, kern, 30)
            stamps = torch.zeros(1 + len(pmk.PHASES), dtype=torch.int64,
                                 device="cuda")
            phases = dict.fromkeys(pmk.PHASES, 0.0)
            for _ in range(10):
                pmk._launch_cuda(fused, h, kp, vp, ks, vs, *meta,
                                 stamps=stamps, **kw)
                t = stamps.tolist()
                for i, ph in enumerate(pmk.PHASES):
                    phases[ph] += (t[i + 1] - t[i]) / 1e6 / 10
            rows.append(dict(layer=label, variant=name, ms=ms,
                             max_abs_err=err,
                             phase_ms=phases))
            print(f"{label} {name}: {ms:.4f} ms (L2 evicted), max|diff| "
                  f"{err:.3e} (tol {tol:.3e}); "
                  f"phases " + ", ".join(f"{k} {v:.4f}"
                                         for k, v in phases.items()),
                  flush=True)
        del fused, pool
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    sys.exit(main())
