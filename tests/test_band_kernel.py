"""The banded aligner's device kernel and the code around it.

* The lax path (ops/wfa.py:_align_device, which XLA compiles for the GPU
  and the CPU) against the host C aligner, score and CIGAR, on batches
  staged exactly as BatchAligner stages them.
* The kernel choice by platform, and the batch slicing by a device memory
  budget (checked on the CPU with a fake allocator limit).
* Tests marked ``gpu`` run the aligner and the phasing EM on the card and
  compare them with the same functions on the CPU
  (``python -m pytest -m gpu tests/test_band_kernel.py`` there); they skip
  on machines without one.
"""

import numpy as np
import pytest

from longcalld_tpu.ops import wfa
from longcalld_tpu.ops.affine_align import align_affine2p

X, O1, E1, O2, E2 = 6, 6, 2, 24, 1


def _mutate(rng, seq, n_sub, n_indel, max_len=4):
    s = list(seq)
    for _ in range(n_sub):
        i = rng.integers(0, len(s))
        s[i] = rng.integers(0, 4)
    for _ in range(n_indel):
        i = rng.integers(0, max(1, len(s)))
        if rng.random() < 0.5 and len(s) > 2:
            del s[i:i + int(rng.integers(1, max_len))]
        else:
            s[i:i] = list(rng.integers(0, 4, int(rng.integers(1, max_len))))
    return np.array(s, dtype=np.uint8)


def _pairs(seed, n, B, Lp, max_len=4):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        p = rng.integers(0, 4, int(rng.integers(3, Lp + 1))).astype(np.uint8)
        t = _mutate(rng, p, int(rng.integers(0, 6)), int(rng.integers(0, 4)),
                    max_len)
        if abs(len(t) - len(p)) + 4 >= B:
            t = t[:len(p)]
        pairs.append((p, t))
    return pairs


def _lax(pairs, B, Lp):
    staged = wfa.stage_pairs(pairs, B, Lp)
    evs, meta = wfa._align_device(*staged, B, Lp, X, O1, E1, O2, E2)
    return staged, np.asarray(evs), np.asarray(meta)


@pytest.mark.parametrize("seed,n,B,Lp,empty", [
    (0, 8, 128, 32, False),
    (1, 8, 128, 96, False),
    (2, 16, 256, 64, False),
    (3, 8, 256, 200, False),
    (7, 8, 128, 48, True),
])
def test_lax_path_matches_host_aligner(seed, n, B, Lp, empty):
    pairs = _pairs(seed, n, B, Lp)
    if empty:
        # an empty pattern takes the row-0 finals path; BatchAligner sends
        # such pairs to the host, so only its score is checked here
        pairs[0] = (np.zeros(0, np.uint8), pairs[0][1][:5])
    (_, _, _, _, dlo), evs, meta = _lax(pairs, B, Lp)
    al = wfa.BatchAligner(X, O1, E1, O2, E2)
    for k, (p, t) in enumerate(pairs):
        host = align_affine2p(p, t, X, O1, E1, O2, E2, left_align=False)
        if len(p) == 0:
            assert meta[k, 0] == host.score
            continue
        r = al._reconstruct(evs[k, :meta[k, 3]], int(meta[k, 1]),
                            int(meta[k, 0]), p, t, int(dlo[k]),
                            int(meta[k, 2]), Lp)
        assert r is not None, f"pair {k} escaped the band"
        assert r.score == host.score
        np.testing.assert_array_equal(r.cigar, host.cigar)


@pytest.mark.parametrize("platform", ["cpu", "gpu", "rocm"])
def test_kernel_choice_by_platform(platform):
    if platform in ("cpu", "gpu"):
        assert wfa.align_kernel(platform) is wfa._align_device
    else:
        with pytest.raises(RuntimeError, match="no banded aligner"):
            wfa.align_kernel(platform)


def test_budget_from_device_allocator_limit():
    class Dev:
        def __init__(self, stats):
            self._stats = stats

        def memory_stats(self):
            return self._stats

    assert wfa._device_budget(Dev(None)) is None
    assert wfa._device_budget(Dev({"bytes_in_use": 1})) is None
    limit = 60 << 30
    assert wfa._device_budget(Dev({"bytes_limit": limit})) \
        == limit // wfa._ALIGN_MEM_SHARE


def test_chunk_pairs_fits_budget():
    per = wfa._pair_bytes(256, 32768)
    assert per >= 2 * 32768 * 256
    assert wfa._chunk_pairs(2048, per, None) == 2048
    assert wfa._chunk_pairs(2048, per, 2048 * per) == 2048
    c = wfa._chunk_pairs(2048, per, 7 << 30)
    assert c * per <= 7 << 30 < 2 * c * per and c & (c - 1) == 0
    assert wfa._chunk_pairs(64, per, 1) == 1
    assert wfa._pair_bytes(256, 1024) < per


def test_budget_slices_batch_without_changing_results(monkeypatch):
    rng = np.random.default_rng(5)
    pairs = []
    for _ in range(40):       # one (Lp=1024, B=256) group of 40 -> n=64
        p = rng.integers(0, 4, int(rng.integers(260, 300))).astype(np.uint8)
        pairs.append((p, _mutate(rng, p, 4, 3, max_len=20)))
    al = wfa.BatchAligner(X, O1, E1, O2, E2, device_min_cells=1)
    whole = al.align_many(pairs, left_align=False)

    calls = []
    orig = wfa.align_kernel

    def counting(platform):
        fn = orig(platform)

        def run(P, *a):
            calls.append(P.shape[0])
            return fn(P, *a)
        return run

    monkeypatch.setattr(wfa, "align_kernel", counting)
    monkeypatch.setattr(wfa, "_device_budget",
                        lambda dev: 8 * wfa._pair_bytes(256, 1024))
    al2 = wfa.BatchAligner(X, O1, E1, O2, E2, device_min_cells=1)
    sliced = al2.align_many(pairs, left_align=False)
    assert calls == [8] * 8          # 64-pair bucket in 8-pair slices
    for a, b in zip(whole, sliced):
        assert a.score == b.score
        np.testing.assert_array_equal(a.cigar, b.cigar)


@pytest.fixture()
def gpu():
    import jax
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (JAX platform gpu)")
    return devs[0]


@pytest.mark.gpu
def test_aligner_gpu_matches_cpu(gpu):
    import jax
    B, Lp = 256, 1024
    pairs = _pairs(3, 64, B, Lp, max_len=30)
    staged = wfa.stage_pairs(pairs, B, Lp)
    statics = (B, Lp, X, O1, E1, O2, E2)
    got = wfa._align_device(*jax.device_put(staged, gpu), *statics)
    want = wfa._align_device(*jax.device_put(
        staged, jax.devices("cpu")[0]), *statics)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.gpu
def test_phase_kernel_gpu_matches_cpu(gpu):
    import jax

    from longcalld_tpu.ops import phase_kernel as pk
    from longcalld_tpu.parallel.mesh import make_example_window_batch
    batch = make_example_window_batch(n_windows=1, n_reads=8192,
                                      n_vars=512, seed=2)
    args = [np.asarray(a[0]) for a in batch]
    out_g = pk.phase_fixpoint_kernel(*jax.device_put(args, gpu))
    out_c = pk.phase_fixpoint_kernel(*jax.device_put(
        args, jax.devices("cpu")[0]))
    for f in pk.PhaseKernelOut._fields:
        np.testing.assert_array_equal(np.asarray(getattr(out_g, f)),
                                      np.asarray(getattr(out_c, f)), f)
