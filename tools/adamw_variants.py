#!/usr/bin/env python3
"""Time the port's fused AdamW kernel on the llama_125m and llama_1b f32
buckets for edited copies of its CUDA source.

    python3 tools/adamw_variants.py [--presets] \\
        [--variant 'NAME:OLD=>NEW[@@OLD=>NEW]'] [--sizes 134105856,...]

A variant is ``paddle_tpu_torch/kernels/csrc/fused_adamw.cu`` with each
text before ``=>`` replaced by the text after it; it is built beside the
real source for the run and deleted after. ``--presets`` adds the
L2-only accesses swapped for streaming ones (``ld.global.cs`` /
``st.global.cs``), twice the vectors in flight per thread, and both.
Each variant is checked bitwise against the plain version on a small
bucket, then timed by ``chip_smoke.time_ms`` (CUDA events, the L2
evicted) at each size in turns: base, variant, variant, base. Needs one
CUDA card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

HINTS = "__ldcg(=>__ldcs(@@__stcg(=>__stcs("
UNROLL = ("constexpr int kUnroll = sizeof(T) == 4 ? 4 : 2;=>"
          "constexpr int kUnroll = sizeof(T) == 4 ? 8 : 4;")
PRESETS = {"cs": HINTS, "unroll2x": UNROLL,
           "cs_unroll2x": f"{HINTS}@@{UNROLL}"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--presets", action="store_true")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME:OLD=>NEW[@@OLD=>NEW], an edited copy of the "
                         "source")
    ap.add_argument("--sizes", default="134105856,1034500000",
                    help="bucket lengths (f32 elements), comma-separated")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import fused_adamw as tfw

    specs = list(args.variant)
    if args.presets:
        specs += [f"{k}:{v}" for k, v in PRESETS.items()]
    src = (_build.CSRC / "fused_adamw.cu").read_text()
    sources, written = {"base": "fused_adamw"}, []
    for spec in specs:
        name, edits = spec.split(":", 1)
        text = src
        for edit in edits.split("@@"):
            old, new = edit.split("=>", 1)
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in the "
                                 f"source")
            text = text.replace(old, new)
        path = _build.CSRC / f"fused_adamw_variant_{name}.cu"
        path.write_text(text)
        written.append(path)
        sources[name] = path.stem
    base = tfw._library()
    try:
        print(cs.card_line(), flush=True)
        print(f"built in {_build.build(list(sources.values())):.2f} s",
              flush=True)
        libs = {}
        for name, stem in sources.items():
            lib = _build.load(stem)
            lib.fused_adamw.argtypes = base.fused_adamw.argtypes
            lib.fused_adamw.restype = base.fused_adamw.restype
            libs[name] = lib
            for sym, info in sorted(cs.build_info(_build, stem)[0].items()):
                if "fused_adamw_kernel" in sym:
                    dt = "bf16" if "bfloat16" in sym else "f32"
                    print(f"[build] {name} {dt}: {info.get('registers')} "
                          f"registers, spills {info.get('spills')}",
                          flush=True)
        check(torch, tfw, libs)
        for n in (int(x) for x in args.sizes.split(",")):
            time_size(torch, cs, tfw, libs, n)
    finally:
        tfw._library = lambda: base
        for path in written:
            path.unlink(missing_ok=True)
    return 0


def check(torch, tfw, libs):
    n = 100_003
    g = torch.Generator(device="cuda").manual_seed(1)
    p = torch.randn(n, device="cuda", generator=g)
    gr = torch.randn(n, device="cuda", generator=g) * 1e-2
    m = torch.randn(n, device="cuda", generator=g) * 1e-3
    v = torch.rand(n, device="cuda", generator=g) * 1e-5
    sc = torch.tensor(tfw.adamw_scalars(1e-3, 2, 0.9, 0.999), device="cuda")
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              decoupled=True)
    want = [x.clone() for x in (p, m, v)]
    tfw.fused_adamw_reference(want[0], gr, want[1], want[2], sc, **kw)
    for name, lib in libs.items():
        tfw._library = lambda lib=lib: lib
        got = [x.clone() for x in (p, m, v)]
        tfw.fused_adamw(got[0], gr, got[1], got[2], sc, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"variant {name} is not bitwise the plain "
                                 f"version")


def time_size(torch, cs, tfw, libs, n):
    g = torch.Generator(device="cuda").manual_seed(5)
    p = torch.randn(n, device="cuda", generator=g)
    gr = torch.randn(n, device="cuda", generator=g) * 1e-2
    m = torch.zeros(n, device="cuda")
    v = torch.zeros(n, device="cuda")
    sc = torch.tensor(tfw.adamw_scalars(1e-4, 3, 0.9, 0.999), device="cuda")
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
              decoupled=True)
    bound = 28 * n / 3.35e12 * 1e3
    for name, lib in libs.items():
        if name == "base":
            continue
        for who in ("base", name, name, "base"):
            tfw._library = lambda lib=libs[who]: lib
            ms = cs.time_ms(torch, lambda: tfw.fused_adamw(p, gr, m, v, sc,
                                                           **kw), 10)
            print(f"bucket {n} f32, {who}: {ms:.4f} ms (bound {bound:.4f}, "
                  f"{bound / ms:.1%} of it)", flush=True)
    del p, gr, m, v
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
