#!/usr/bin/env python3
"""Proof that `longcalld-tpu call` runs on one NVIDIA GPU.

    python chip_smoke.py            # phases A-C on one card
    python chip_smoke.py --four     # phase D only: the multi-card paths

A. Environment: the card (nvidia-smi), JAX's devices (the platform must be
   ``gpu``), versions, XLA_FLAGS and the compile-cache directory.
B. Kernels at real widths.  The banded aligner (the lax formulation XLA
   compiles for the GPU) timed at the device's band and batch buckets, its
   reconstructed alignments checked against the host C aligner (score and
   CIGAR); the phasing EM on the GPU against the same function on the CPU,
   field by field, at R = 2048 and R = 8192, timed with its per-variant
   sweep.
C. The main path through the CLI on a seeded synthetic genome (5 Mb random
   contig, planted SNVs/indels/SVs, 30x 15 kb HiFi-like reads): default
   routing, every device-eligible pair forced to the card, and --no-device.
   The three VCF bodies must be byte-identical; F1 against the planted
   truth is printed.
D. (--four) The multi-card paths users can reach — window round-robin over
   all cards, the reads-sharded phasing mesh, and device-owning worker
   processes — each against the one-card VCF, with every card's peak
   memory as the proof that it did work.

The parent process never imports JAX: each phase that touches a card runs
in its own child process, one after another.  Any failed check exits
non-zero.  The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RESULT = "SMOKE_RESULT "
SEED = 0
WORK = os.path.join(ROOT, "build", "smoke")   # git-ignored, removed at exit
CONTIG_MB = 5.0

ALIGN_SHAPES = ((64, 1024), (512, 2048), (2048, 1024), (64, 4096),
                (64, 32768))
PHASE_SHAPES = ((2048, 2048), (8192, 2048))
PENALTIES = dict(x=6, o1=6, e1=2, o2=24, e2=1)   # CallOpts defaults


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def emit(obj) -> None:
    """A child's result, parsed by the parent."""
    print(RESULT + json.dumps(obj), flush=True)


def median_s(fn, reps: int = 5) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


# ---------------------------------------------------------------- children

def child_env() -> None:
    """Phase A: what runs where."""
    import jax
    import jaxlib

    from longcalld_tpu.utils.device import cache_dir, init_device
    init_device()
    devs = jax.devices()
    d = devs[0]
    print(f"jax {jax.__version__} jaxlib {jaxlib.__version__}")
    print(f"devices: platform={d.platform} kind={d.device_kind} "
          f"count={len(devs)}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache: {cache_dir()}")
    check(d.platform == "gpu", f"JAX platform is {d.platform!r}, not gpu")
    emit({"platform": d.platform, "kind": d.device_kind, "count": len(devs)})


def _pairs(rng, n: int, Lp: int):
    """Seeded 1%-divergent pairs (0.8% substitutions, 0.2% 1-3 bp indels)
    whose pattern lengths fill the Lp row bucket.  Differences are capped
    at 32 substitutions and 8 indels per pair: a longer pair at 1% scores
    past the band-escape bound and goes to the host aligner by design."""
    import numpy as np
    out = []
    for _ in range(n):
        L = int(rng.integers(Lp // 2 + 1, Lp + 1))
        p = rng.integers(0, 4, L).astype(np.uint8)
        t = p.copy()
        mut = rng.choice(L, min(32, max(1, L // 125)), replace=False)
        t[mut] = (t[mut] + 1 + rng.integers(0, 3, len(mut))) % 4
        for _ in range(min(8, max(1, L // 500))):
            i = int(rng.integers(0, len(t)))
            ln = int(rng.integers(1, 4))
            if rng.random() < 0.5:
                t = np.concatenate([t[:i], t[i + ln:]])
            else:
                t = np.concatenate([t[:i], rng.integers(0, 4, ln)
                                    .astype(np.uint8), t[i:]])
        out.append((p, t))
    return out


def child_kernels(seed: int) -> None:
    """Phase B: the aligner and the phasing EM at real widths."""
    import jax
    import numpy as np

    from longcalld_tpu.ops import wfa
    from longcalld_tpu.ops.affine_align import align_affine2p_many
    from longcalld_tpu.utils.device import init_device
    init_device()
    check(jax.devices()[0].platform == "gpu", "phase B needs the GPU")

    B = 256
    pen = PENALTIES
    rng = np.random.default_rng(seed)
    al = wfa.BatchAligner(use_device=True, device_min_cells=1)
    rows = []
    for n, Lp in ALIGN_SHAPES:
        pairs = _pairs(rng, n, Lp)
        check(wfa._bucket(max(len(p) for p, _ in pairs)) == Lp,
              f"pairs miss the Lp={Lp} bucket")
        host = jax.device_put(wfa.stage_pairs(pairs, B, Lp))
        args = (*host, B, Lp, pen["x"], pen["o1"], pen["e1"], pen["o2"],
                pen["e2"])

        def run():
            return jax.block_until_ready(wfa._align_device(*args))

        t0 = time.perf_counter()
        evs, meta = (np.asarray(a) for a in run())
        first = time.perf_counter() - t0

        # reconstructed alignments against the host C aligner
        hosts = align_affine2p_many(pairs, [False] * n, pen["x"], pen["o1"],
                                    pen["e1"], pen["o2"], pen["e2"],
                                    n_threads=8)
        check(hosts is not None, "host C aligner unavailable")
        n_escape = 0
        dlo = np.asarray(host[4])
        for k, (p, t) in enumerate(pairs):
            ne = int(meta[k, 3])
            r = (al._reconstruct(evs[k, :ne], int(meta[k, 1]),
                                 int(meta[k, 0]), p, t, int(dlo[k]),
                                 int(meta[k, 2]), Lp)
                 if ne >= 0 else None)
            if r is None:
                n_escape += 1     # production re-runs these on the host
                continue
            h = hosts[k]
            check(r.score == h.score and np.array_equal(r.cigar, h.cigar),
                  f"(n={n}, Lp={Lp}) pair {k}: device alignment "
                  f"{r.score} != host C {h.score}")
        check(n_escape < n // 8 + 1,
              f"(n={n}, Lp={Lp}): {n_escape} pairs escaped the band")

        ms = median_s(run) * 1e3
        cells = int(sum(len(p) for p, _ in pairs)) * B
        rows.append({"n": n, "Lp": Lp, "B": B, "ms": ms, "first_s": first,
                     "band_cells": cells, "cells_per_s": cells / ms * 1e3,
                     "band_escapes": n_escape})
        print(f"align n={n:5d} Lp={Lp:6d} B={B}: {ms:10.3f} ms "
              f"({cells / ms * 1e3:.3e} band cells/s)  first call "
              f"{first:.1f} s  escapes {n_escape}  == host C", flush=True)
    n, Lp = ALIGN_SHAPES[-1]
    ma = wfa._align_device.lower(*args).compile().memory_analysis()
    print(f"memory_analysis (n={n}, Lp={Lp}, B={B}): {ma}")

    phase = child_phase_kernel(seed)
    emit({"align": rows, "phase": phase})


def child_phase_kernel(seed: int) -> list:
    import jax
    import numpy as np

    from longcalld_tpu.ops import phase_kernel as pk
    from longcalld_tpu.parallel.mesh import make_example_window_batch
    cpu = jax.devices("cpu")[0]
    gpu = jax.devices()[0]
    rows = []
    for R, V in PHASE_SHAPES:
        batch = make_example_window_batch(n_windows=1, n_reads=R, n_vars=V,
                                          seed=seed)
        args = [np.asarray(a[0]) for a in batch]
        on_gpu = jax.device_put(args, gpu)
        out_g = jax.block_until_ready(pk.phase_fixpoint_kernel(*on_gpu))
        out_c = pk.phase_fixpoint_kernel(*jax.device_put(args, cpu))
        for f in pk.PhaseKernelOut._fields:
            a, b = np.asarray(getattr(out_g, f)), np.asarray(getattr(out_c, f))
            check(np.array_equal(a, b),
                  f"phase kernel (R={R}, V={V}) field {f}: GPU != CPU")
        ms = median_s(lambda: jax.block_until_ready(
            pk.phase_fixpoint_kernel(*on_gpu))) * 1e3
        # the per-variant sweep alone, once per fixpoint round
        sv = [jax.device_put(x, gpu) for x in (
            np.ones(V, bool), np.ones(V, bool), np.zeros(V, np.int32),
            np.zeros(V, np.int32), np.int32(0))]
        scan = jax.jit(pk._ps_scan)
        jax.block_until_ready(scan(*sv))
        scan_ms = median_s(lambda: jax.block_until_ready(scan(*sv))) * 1e3
        rows.append({"R": R, "V": V, "ms": ms, "ps_scan_ms": scan_ms,
                     "n_iter": int(out_g.n_iter)})
        print(f"phase kernel R={R} V={V}: {ms:.3f} ms per window "
              f"(n_iter={int(out_g.n_iter)}; ps_flip sweep {scan_ms:.3f} "
              f"ms per round, up to 10 rounds)  GPU == CPU", flush=True)
    return rows


def child_multi(ref: str, bam: str, mode: str) -> None:
    """Phase D: one multi-card path in this process (window round-robin or
    the reads-sharded mesh), with every card's peak memory."""
    import io

    import jax

    from longcalld_tpu.config import CallOpts
    from longcalld_tpu.core.pipeline import run_call
    devs = jax.devices()
    check(all(d.platform == "gpu" for d in devs), "phase D needs GPUs")
    kw = ({"window_devices": 0} if mode == "windows"
          else {"mesh_devices": len(devs)})
    buf = io.StringIO()
    t0 = time.perf_counter()
    run_call(CallOpts.hifi(ref_fa_fn=ref, in_bam_fns=[bam], **kw), buf,
             "smoke")
    wall = time.perf_counter() - t0
    peaks = [int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
             for d in devs]
    emit({"mode": mode, "wall_s": wall, "peaks": peaks,
          "kind": devs[0].device_kind, "count": len(devs),
          "body": vcf_body(buf.getvalue())})


def child_procs(ref: str, bam: str, n: int) -> None:
    """Phase D: device-owning worker processes, worker k on card k.  This
    process opens no card."""
    import io

    from longcalld_tpu.config import CallOpts
    from longcalld_tpu.core.pipeline import run_call
    from longcalld_tpu.utils import counters
    buf = io.StringIO()
    t0 = time.perf_counter()
    run_call(CallOpts.hifi(ref_fa_fn=ref, in_bam_fns=[bam], n_threads=n,
                           host_procs=n, procs_use_device=True), buf,
             "smoke")
    wall = time.perf_counter() - t0
    snap = counters.snapshot()
    peaks = [int(snap.get(f"aln_device_peak_bytes_w{k}", 0))
             for k in range(n)]
    emit({"mode": "procs", "wall_s": wall, "peaks": peaks,
          "body": vcf_body(buf.getvalue())})


# ------------------------------------------------------------------ parent

def vcf_body(text: str) -> str:
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith("##"))


def run_child(args, env=None, label=""):
    """Run ``chip_smoke.py --child ...`` and return its parsed result."""
    cmd = [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--seed",
           str(SEED), "--child", *[str(a) for a in args]]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         text=True)
    res = None
    for ln in out.stdout.splitlines():
        if ln.startswith(RESULT):
            res = json.loads(ln[len(RESULT):])
        else:
            print(f"  {ln}")
    sys.stdout.flush()
    check(out.returncode == 0 and res is not None,
          f"child {label or args[0]} failed (rc={out.returncode})")
    res["_wall_s"] = time.perf_counter() - t0
    return res


def card_label() -> str:
    """`name, power.limit` of every visible card, as nvidia-smi gives it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise SmokeError(f"nvidia-smi unavailable: {e}") from e
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def make_data(work: str, seed: int, contig_mb: float):
    """Seeded synthetic genome + reads (tests/synthcontig.py)."""
    import numpy as np
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synthcontig import build_truth, write_synth_bam, write_synth_fasta
    rng = np.random.default_rng(seed)
    L = int(contig_mb * 1e6)
    ref4 = rng.integers(0, 4, L).astype(np.uint8)
    beg, end = 10_000, L - 10_000
    truth = build_truth(rng, ref4, beg, end)
    ref, bam = os.path.join(work, "ref.fa"), os.path.join(work, "reads.bam")
    t0 = time.perf_counter()
    write_synth_fasta(ref, "chr1", ref4)
    n_reads = write_synth_bam(bam, "chr1", L, ref4, truth, beg, end,
                              coverage=30, read_len=15_000, err=0.001,
                              seed=seed + 1)
    print(f"data: {L / 1e6:.1f} Mb contig, {len(truth)} planted variants, "
          f"{n_reads} reads ({n_reads * 15_000 / 1e6:.0f} Mbp) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return ref, bam, (truth, beg, end, ref4)


def cli_call(ref, bam, out_vcf, extra, env=None):
    """One `longcalld-tpu call` process; returns (wall, VCF body, log)."""
    cmd = [sys.executable, "-m", "longcalld_tpu.cli", "call", ref, bam,
           "--hifi", "-V", "-o", out_vcf, *extra]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True)
    wall = time.perf_counter() - t0
    log = out.stderr
    with open(out_vcf + ".log", "w") as f:
        f.write(log)
    if out.returncode != 0:
        print(log[-3000:])
    check(out.returncode == 0, f"call {' '.join(extra)} failed "
          f"(rc={out.returncode})")
    with open(out_vcf) as f:
        return wall, vcf_body(f.read()), log


def log_value(log: str, key: str):
    """The integer after ``key=`` or ``key:`` in a -V log (last match)."""
    import re
    got = re.findall(re.escape(key) + r"[=:] ?(-?\d+)", log)
    return int(got[-1]) if got else None


def phase_c(work, seed, contig_mb, label):
    ref, bam, (truth, beg, end, ref4) = make_data(work, seed, contig_mb)
    from synthcontig import evaluate_f1
    runs = {}
    for name, extra in (("default", []),
                        ("forced", ["--device-min-cells", "1"]),
                        ("no-device", ["--no-device"])):
        wall, body, log = cli_call(ref, bam,
                                   os.path.join(work, f"{name}.vcf"), extra)
        runs[name] = (wall, body, log)
        print(f"call {name:9s} [{label}]: wall {wall:.2f} s  "
              f"cells_device={log_value(log, 'cells_device')} "
              f"cells_host={log_value(log, 'cells_host')} "
              f"cells_memo={log_value(log, 'cells_memo')} "
              f"phase_kernel_dispatch="
              f"{log_value(log, 'count phase_kernel_dispatch')}",
              flush=True)
    thr = log_value(runs["default"][2], "device routing threshold")
    print(f"routing threshold (calibrate_min_cells): {thr} cells")
    bodies = {k: v[1] for k, v in runs.items()}
    check(bodies["default"] == bodies["forced"] == bodies["no-device"],
          "default, forced-device and --no-device VCF bodies differ")
    flog = runs["forced"][2]
    check((log_value(flog, "cells_device") or 0) > 0,
          "forced run put no alignment cells on the device")
    check((log_value(flog, "count phase_kernel_dispatch") or 0) > 0,
          "forced run dispatched no phase kernel")
    check("platform=gpu" in flog, "forced run did not log platform=gpu")
    recs = [ln for ln in bodies["forced"].splitlines()
            if not ln.startswith("#")]
    check(len(recs) > 100, f"only {len(recs)} VCF records")
    f1 = evaluate_f1(recs, truth, beg, end, ref4)
    print("F1 vs planted truth: " + "  ".join(
        f"{k} {v['f1']:.4f} (tp {v['tp']} fp {v['fp']} fn {v['fn']})"
        for k, v in f1.items()))


def phase_d(work, seed, contig_mb, label):
    ref, bam, _ = make_data(work, seed, contig_mb)
    env1 = dict(os.environ, CUDA_VISIBLE_DEVICES="0")
    wall, one, _ = cli_call(ref, bam, os.path.join(work, "one.vcf"), [],
                            env=env1)
    print(f"one-card call [{label}]: wall {wall:.2f} s")
    res = None
    for mode in ("windows", "mesh"):
        res = run_child(["multi", ref, bam, mode], label=mode)
        print(f"{mode}: wall {res['wall_s']:.2f} s, peak bytes per card "
              f"{res['peaks']}")
        check(res["body"] == one, f"{mode} VCF differs from the one-card VCF")
        check(len(res["peaks"]) == 4 and all(p > 0 for p in res["peaks"]),
              f"{mode}: not every card did work: {res['peaks']}")
    pr = run_child(["procs", ref, bam, 4], label="procs")
    print(f"procs: wall {pr['wall_s']:.2f} s, peak bytes per worker "
          f"{pr['peaks']}")
    check(pr["body"] == one, "procs VCF differs from the one-card VCF")
    check(all(p > 0 for p in pr["peaks"]),
          f"procs: not every worker's card did work: {pr['peaks']}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths (phase D)")
    ap.add_argument("--child", nargs="+", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    global SEED
    SEED = a.seed

    if a.child:
        kind, rest = a.child[0], a.child[1:]
        {"env": lambda: child_env(),
         "kernels": lambda: child_kernels(a.seed),
         "multi": lambda: child_multi(*rest),
         "procs": lambda: child_procs(rest[0], rest[1], int(rest[2])),
         }[kind]()
        return 0

    if not os.path.isdir(os.path.join(ROOT, "longcalld_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    try:
        label = card_label()
        print(f"card: {label}", flush=True)
        env = run_child(["env"], label="A")
        card = label.splitlines()[0]
        os.makedirs(WORK, exist_ok=True)
        if a.four:
            check(env["count"] >= 4, f"--four needs 4 cards, JAX sees "
                  f"{env['count']}")
            res = phase_d(WORK, a.seed, CONTIG_MB, card)
            device = {"platform": env["platform"], "kind": res["kind"],
                      "count": res["count"]}
        else:
            run_child(["kernels"], label="B")
            phase_c(WORK, a.seed, CONTIG_MB, card)
            device = {"platform": env["platform"], "kind": env["kind"],
                      "count": env["count"]}
    except SmokeError as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if os.path.isdir(WORK):
            shutil.rmtree(WORK, ignore_errors=True)
    print(f"card: {label}")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
