#!/usr/bin/env python3
"""Time the port's decode megakernel at one full-width Llama-2-7B layer
(8 decode rows, kv 49-632) for edited copies of its CUDA source, beside
the kernel of another checkout (the parent commit's).

    python3 tools/decode_variants.py [--parent DIR] [--presets] \\
        [--variant 'NAME:OLD=>NEW[@@OLD=>NEW]'] [--json PATH]

A variant is ``paddle_tpu_torch/kernels/csrc/decode_megakernel.cu`` with
each text before ``=>`` replaced by the text after it; it is built beside
the real source for the run and deleted after. ``--parent DIR`` is a
checkout of another commit (``git archive`` unpacked into an ignored
directory): its own package builds and launches its own kernel, in turns
with this one (parent, base, base, parent), so "before" and "after" come
from one call on one card. ``--presets`` adds the knobs the design left
open: the ring's depth and stage bytes, strips of 512-byte bf16 and
256-byte int8 weight rows, an attention ring 4 units deep, each barrier
fold
(the combine into the o projection's x staging, the act into the
down projection's), an empty phase
(one grid barrier and nothing else) whose stamp is a barrier's cost, and
the ring streaming with nothing computed.

Every source runs in a process of its own (its package, its library):
held against the plain version (``chip_smoke.mega_err``; one that fails
is reported and timed all the same), timed by ``chip_smoke.time_ms``
(CUDA events, the L2 evicted) at the bf16 layer and the int8 w + int8
pool layer of ``chip_smoke``'s timing phase, in the launch a layer-scope
burst makes (one layer, each row's K/V appended into its pool slot in
the kernel), beside its phase stamps (10 launches, L2 warm). The variants' builds run in parallel first and print
registers, spills and HMMA counts. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STEM = "decode_megakernel"

FOLD_COMBINE = (
    "constexpr int kPhases = 10;=>constexpr int kPhases = 9;@@"
    "    for (int i = gtid; i < R * H * dh; i += gstride)\n"
    "      p.o[i] = combine_at<T>(p, i / (H * dh), i % (H * dh));\n"
    "    phase_end(p, ph++);\n=>@@"
    "            Val<float>::ld8(p.o + (size_t)r * H * dh + k, v);=>"
    "            for (int j = 0; j < 8; ++j) "
    "v[j] = combine_at<T>(p, r, k + j);")
FOLD_ACT = (
    "constexpr int kPhases = 10;=>constexpr int kPhases = 9;@@"
    "    for (int i = gtid; i < R * F; i += gstride)\n"
    "      p.act[i] = act_at<T>(p, sc(P_SG), sc(P_SU), i / F, i % F);\n"
    "    phase_end(p, ph++);\n=>@@"
    "            Val<float>::ld8(p.act + (size_t)r * F + k, v);=>"
    "            for (int j = 0; j < 8; ++j) "
    "v[j] = act_at<T>(p, sc(P_SG), sc(P_SU), r, k + j);")

PRESETS = {
    # ring depth and stage bytes: bf16 weights 4 x 32 KB, int8 8 x 16 KB
    "bf16_depth5": "DEPTH = sizeof(W) == 2 ? 4 : 8;=>"
                   "DEPTH = sizeof(W) == 2 ? 5 : 8;",
    "bf16_stage16k": "STAGE = sizeof(W) == 2 ? 32768 : 16384;=>"
                     "STAGE = sizeof(W) == 2 ? 16384 : 16384;@@"
                     "DEPTH = sizeof(W) == 2 ? 4 : 8;=>"
                     "DEPTH = sizeof(W) == 2 ? 8 : 8;",
    "int8_depth4": "DEPTH = sizeof(W) == 2 ? 4 : 8;=>"
                   "DEPTH = sizeof(W) == 2 ? 4 : 4;",
    # strips of 512-byte bf16 rows, 256-byte int8 rows
    "bf16_strip4": "NB = sizeof(W) == 2 ? 8 :=>NB = sizeof(W) == 2 ? 4 :",
    "int8_strip2": "kBf16 ? 4 :=>kBf16 ? 2 :",
    # the attention ring 4 units deep
    "attn_stages4": "constexpr int kAttnStages = 2;=>"
                    "constexpr int kAttnStages = 4;",
    # the combine phase folded into the o projection's x staging (each o
    # unit merges the splits of its own K chunk), the act phase into the
    # down projection's (each down unit forms silu(gate) * up of its own
    # chunk), and both: one grid barrier a layer less each
    "fold_combine": FOLD_COMBINE,
    "fold_act": FOLD_ACT,
    "fold_both": FOLD_COMBINE + "@@" + FOLD_ACT.replace(
        "kPhases = 10;=>constexpr int kPhases = 9;",
        "kPhases = 9;=>constexpr int kPhases = 8;"),
    # one more grid barrier a layer, with nothing before it: its stamp is
    # a barrier's cost
    "empty_phase": "constexpr int kPhases = 10;=>"
                   "constexpr int kPhases = 11;@@"
                   "p.stamps != nullptr) phase_end(p, ph++);=>"
                   "p.stamps != nullptr) phase_end(p, ph++);\n"
                   "    phase_end(p, ph++);",
    # the weights streamed and nothing computed from them: the ring's
    # own rate (its results are not held)
    "stream_only": "      if constexpr (kTC)\n        mma_strip<W, B>(=>"
                   "      if constexpr (false)\n        mma_strip<W, B>(@@"
                   "      else\n        fma_strip<W, B>(=>"
                   "      else if constexpr (!kTC)\n        fma_strip<W, B>(",
}


def edited(src, spec):
    """(name, text) of a variant spec ``NAME:OLD=>NEW[@@OLD=>NEW]``."""
    name, edits = spec.split(":", 1)
    for edit in edits.split("@@"):
        old, new = edit.split("=>", 1)
        if old not in src:
            raise SystemExit(f"variant {name}: {old!r} is not in the source")
        src = src.replace(old, new)
    return name, src


def worker(root, stem):
    """Check and time the kernel of checkout ``root`` (library ``stem``);
    print one JSON line."""
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import decode_megakernel as dmk
    from paddle_tpu_torch.models.llama import llama2_7b_config
    torch.backends.cuda.matmul.allow_tf32 = False
    if stem != STEM:
        base = dmk._library()
        lib = _build.load(stem)
        for fn in dir(base):
            if fn.startswith(STEM) and hasattr(lib, fn):
                getattr(lib, fn).argtypes = getattr(base, fn).argtypes
                getattr(lib, fn).restype = getattr(base, fn).restype
        dmk._library = lambda: lib
    cfg = llama2_7b_config()
    kw = dict(eps=cfg.rms_norm_eps, theta=cfg.rope_theta, num_heads=32)
    out = {}
    for label, quant in (("bf16", False), ("int8", True)):
        lyr = cs.mega_layers(torch, 1, quant, seed=31)[0]
        h, pools, tbl, kv_lens = cs.mega_inputs(torch, quant, 1, seed=32)
        R = h.shape[0]
        pos = kv_lens - 1
        page = tbl[torch.arange(R, device="cuda"), (pos // cs.PAGE).long()]
        append_at = (page.contiguous(), (pos % cs.PAGE).to(torch.int32))
        rope = dmk._rope_tables(kv_lens, cfg.rope_theta, 128)
        one = lambda t: None if t is None else [t]        # noqa: E731

        def launch(kp, vp, ks, vs, **extra):
            # the launch a layer-scope burst makes: one layer, each row's
            # K/V written into its pool slot in the kernel
            return dmk._launch_cuda(
                [lyr], h, [kp], [vp], one(ks), one(vs), tbl, kv_lens,
                self_kv=not quant, append_at=append_at, rope_tables=rope,
                **extra, **kw)[0]

        def fresh():            # the pool as it was, for each side
            return [None if t is None else t.clone() for t in pools[0]]
        c = fresh()
        want = dmk._plain_model(
            [lyr], h, [c[0]], [c[1]], one(c[2]), one(c[3]), tbl, kv_lens,
            kw["eps"], kw["theta"], kw["num_heads"], not quant, None, None,
            append_at, None)
        try:
            err = cs.mega_err(torch, launch(*fresh()), want)[0]
            held = True
        except AssertionError as e:
            err, held = str(e), False
        kern = lambda: launch(*pools[0])                   # noqa: E731
        ms = cs.time_ms(torch, kern, 50)
        # the phases a layer: limits[4] (limits[6] before the strips, as
        # the parent commit's kernel reports them)
        limits = (ctypes.c_int * 8)()
        dmk._library().decode_megakernel_limits(limits)
        n = limits[6] if limits[6] == len(dmk.PHASES) else limits[4]
        # an edited source may have more phases (an empty one last) or
        # fewer (a barrier folded)
        names = list(dmk.PHASES)[:n] + [f"extra {i}" for i in range(
            n - len(dmk.PHASES))] if n >= len(dmk.PHASES) else \
            [f"phase {i}" for i in range(n)]
        stamps = torch.zeros(1 + n, dtype=torch.int64, device="cuda")
        phases = dict.fromkeys(names, 0.0)
        for _ in range(10):
            launch(*pools[0], stamps=stamps)
            t = stamps.tolist()
            for i, name in enumerate(names):
                phases[name] += (t[i + 1] - t[i]) / 1e6 / 10
        out[label] = dict(ms=ms, held=held, max_abs_err=err, phase_ms=phases)
        del lyr, pools, want, c
        torch.cuda.empty_cache()
    print("RESULT " + json.dumps(out), flush=True)


def run_worker(root, stem):
    proc = subprocess.run(
        [sys.executable, __file__, "--worker", str(root), "--stem", stem],
        capture_output=True, text=True, cwd=str(root))
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[7:])
    raise RuntimeError(f"worker {root} {stem} failed ({proc.returncode}):\n"
                       f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of another commit")
    ap.add_argument("--presets", action="store_true",
                    help="time the preset variants too")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME:OLD=>NEW[@@OLD=>NEW], an edited copy of the "
                         "source")
    ap.add_argument("--json", help="write the rows here")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--stem", default=STEM, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(Path(args.worker), args.stem)
        return 0
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build

    specs = list(args.variant)
    if args.presets:
        specs += [f"{k}:{v}" for k, v in PRESETS.items()]
    src = (_build.CSRC / f"{STEM}.cu").read_text()
    stems, written = {"base": STEM}, []
    for spec in specs:
        name, text = edited(src, spec)
        path = _build.CSRC / f"{STEM}_variant_{name}.cu"
        path.write_text(text)
        written.append(path)
        stems[name] = path.stem
    rows = []
    try:
        print(cs.card_line(), flush=True)
        parent_build = None
        if args.parent:
            parent_build = subprocess.Popen(
                [sys.executable, "-c", "from paddle_tpu_torch.kernels import "
                 f"_build; _build.build(['{STEM}'])"], cwd=args.parent)
        print(f"built in {_build.build(list(stems.values())):.2f} s",
              flush=True)
        if parent_build is not None and parent_build.wait() != 0:
            raise RuntimeError("the parent's build failed")
        for name, stem in stems.items():
            print(f"[{name}]", flush=True)
            cs.report_decode_build(_build, stem, strict=False)
        order = [("base", ROOT, STEM)] * 2
        if args.parent:
            parent = Path(args.parent).resolve()
            order = [("parent", parent, STEM)] + order + \
                [("parent", parent, STEM)]
        order += [(n, ROOT, s) for n, s in stems.items() if n != "base"]
        for name, root, stem in order:
            res = run_worker(root, stem)
            rows.append(dict(variant=name, **res))
            for label in ("bf16", "int8"):
                r = res[label]
                print(f"{name:12s} {label}: {r['ms']:.4f} ms"
                      f"{'' if r['held'] else ' (NOT held: ' + str(r['max_abs_err']) + ')'}"
                      f"; phases " + ", ".join(
                          f"{k} {v:.4f}" for k, v in r["phase_ms"].items()),
                      flush=True)
    finally:
        for path in written:
            path.unlink(missing_ok=True)
    if args.json:
        Path(args.json).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
