#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (orion_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --forward-copies DIR   (see `forward_copies`)

Phases, each printing its own lines; a failure says why on stdout and
stderr and exits 1:
  1. the card's name and power limit, the kernel build time (every CUDA
     source of the port is compiled here, in parallel), ptxas' registers
     and spills of each kernel at LogN 13 and 14 (the run fails if a
     kernel of the standard key-switch's hoisted conversion or of
     rescale_poly spills), the
     CTAs per row of the cluster transforms at each ring size and of the
     key-switch kernels' ConjugateInvariant forms at each lift size (more
     than one at LogN 13 and 14, or the run fails), and the device
     kernels of one key-switch from a profile (ks_decompose's and
     ks_finish's three grids each, or the run fails);
  2. each hand-written kernel against its plain PyTorch version on the
     card (N = 8192) at every level of configs/mlp.yml (0-5), of
     configs/lenet.yml (0-7, 4 digits at levels 6-7) and of
     configs/resnet.yml (44 Q primes, 6 special primes: 50 extended
     rows and 8 digits at the top) at levels 1, 17, 42, 43 (timed), 2-5,
     8-10 and each sixth level (with the timed ones: each digit count and
     each size of the last digit), the rescale epilogues at all of 1-43,
     one key-switch per call: the
     transforms also batched over two polys as rescale_poly gives them,
     ks_finish with full-chain and trimmed keys, Shoup and lean,
     ks_finish_raw (no ModDown), the rescale epilogues at every
     level >= 1 (mod_drop_rescale and rescale_poly over one ciphertext and
     over a batch of 2: each of their two launches and the pair), and the
     PallasNTT counterpart (crypto/ntt_pallas.py) over chosen limb rows;
     one profiled call of each epilogue must record exactly its two
     kernels on the card: all must be bit-exact
     (torch.equal, the kernel's output allocated from memory filled with
     -1); per call the kernel's ms (calls back to back, host included,
     as the earlier slices took it), its device ms (calls queued behind
     a sleep kernel, so the host's issue time is left out) and the plain
     version's ms;
  2b. the same for the kernels' ConjugateInvariant forms (`*_ci`: rows of
     n residues, transforms on the 2n lift) at every level of
     configs/lola.yml (N = 8192, transforms of 2^14) and of
     tests/configs/mlp.yml (N = 4096, 2^13): the transforms, the
     rescale_poly pair (the CI ring has no fused drop), ks_decompose and
     ks_finish; one profiled CI rescale_poly must record exactly its two
     kernels, both the CI instantiations;
  2c. 200 rescale_poly calls on distinct ciphertexts queued back to back
     at configs/lenet.yml level 7, configs/resnet.yml level 43 and
     configs/lola.yml level 5 (CI), each output against the plain
     version: launch B starts beside the end of launch A (programmatic
     dependent launch) and must not read A's scratch before A stored it;
     the first of them, a fresh context's first call at the level, also
     against the plain version before the others are queued;
  3. the full-width MLP 784-128-128-10 on configs/mlp.yml through the
     user entry points on `cuda` (then once more with io_mode: stream,
     whose output must equal this one bit for bit, with its compile peak,
     memory after compile, bytes spilled, promoted and uploaded): MAE vs
     cleartext < 0.005, every kernel
     of the path launched during the encrypted forward (the generic
     transforms and rescale_poly's second launch serve PallasNTT, ring_ntt
     and Evaluator.rescale, which neither forward calls), the rescale
     epilogues' launch pairs per level and the device ops, launches and items
     (key-switches) per kernel and level, first and steady latency, a
     profiled forward (device time by kernel; the port's kernels it
     recorded must be those their wrappers launched); the same flow with
     device="cpu" (plain path) must give equal output ciphertexts;
  4. the full-width LeNet on configs/lenet.yml the same way (streamed
     too), with the host seconds of fit and compile, the rotation keys
     made and the peak device memory;
  4b. LoLA at full width on configs/lola.yml (ConjugateInvariant, LogN
     13, 8192 real slots) the same way as phase 3: every CI kernel of the
     path launched, no standard one; the standalone ntt_fwd_ci / ntt_inv_ci
     stay off the path as ntt_fwd / ntt_inv do (their map runs in the
     rescale pair and the key-switch kernels);
  4c. the MLP 784-128-128-10 on tests/configs/mlp.yml (ConjugateInvariant,
     LogN 12), orion_tpu's own MLP/LoLA test config, the same way;
  4d. LoLA on configs/lola2.yml (standard ring, LogN 14), the same way;
  5. one bootstrap on configs/resnet.yml (full slots, lean key packs)
     from one seed on `cuda` and with device="cpu" (plain path, in a
     process of its own while phase 6 runs): equal output ciphertexts,
     the decrypted error against the input, the key-switches per
     bootstrap and its time on the card;
  6. ResNet-20 on configs/resnet.yml through the user entry points on
     `cuda` (weights from the seeded generator the port shares with
     orion_tpu, synthetic CIFAR-10 images): fit, compile (host seconds of
     fit, compile and key generation, rotation keys, key packs and their
     bytes, the bootstraps placed), the ciphertext bootstraps of a forward
     by circuit slot count, a first and a steady forward, MAE vs cleartext
     < 0.005, device memory after compile, at the compile peak and at the
     forward peak, and a profiled forward (device time by kernel, busy
     share, the port's kernels recorded against those the wrappers
     launched).  The config's io_mode: stream spills every module's
     buffers but the pinned ones to pinned host memory at compile: the
     bytes spilled beside the hbm_report total, promoted by the first
     forward under the residency budget and uploaded by the steady one.
     Then the noise profile of the compiled net on the first forward's
     ciphertext (every stage finite, its output equal to that forward's;
     the worst stage and each bootstrap stage's error), and a forward with
     a budget that holds every buffer and a steady one with every buffer
     resident, both equal to the streamed forward;
  6b. AlexNet at full width on configs/alexnet.yml the same way; a
     12-ciphertext tensor must be bootstrapped;
  6c. VGG-11 at full width on configs/vgg.yml the same way; a bootstrap
     on the 2048-slot circuit must run.  6b and 6c each run in a process
     of their own, started after phase 2: AlexNet fits and compiles while
     phases 3-6 run, VGG-11 once AlexNet has compiled, and each runs its
     forwards alone on the card in its turn after phase 6 (`spawn_nets`);
  8. batched serving (runtime/jit.make_batched_forward: B queries stacked
     on a leading axis of every ciphertext, one forward): the MLP on
     configs/mlp.yml at B = 1, 2, 4, 8 and LoLA on configs/lola.yml (CI)
     at B = 8, each batched output equal to its query's serial forward bit
     for bit, MAE < 0.005, every kernel of the path launched; first and
     steady walls, inferences per second, a profiled batched forward,
     key-switch launches and items per level.  ResNet-20 at B = 2 runs
     inside phase 6 on its compiled net: phase 6's ciphertext and a
     second encryption of its input, equal to their serial forwards, with
     the wall, a profiled batched forward (device time, busy share), the
     memory peak beside the single forward's, the bootstraps and
     key-switch items;
  8b. the MLP and LeNet compiled with io_mode save (numpy archives under
     the build directory), then in a fresh scheme with io_mode load: the
     loaded forward of the saved run's ciphertext equal to the saved
     forward; init_scheme and compile seconds of both beside phases 3-4's
     compile, the archives' sizes;
  9. training (orion_tpu_torch/train.py): LeNet, one epoch of 4 SGD
     steps at batch 128 on cuda and on cpu from the same weights, the
     largest relative parameter difference against its TF32 tolerance; a
     checkpoint round trip and write_back; the trained net fitted,
     compiled and served encrypted (MAE < 0.005 against its clear output)
     and its noise profile (9b); ResNet-20 at full width, 4 steps on one
     batch, whose loss must fall;
  9b. the noise profile of TinyVGG (SiLU(15), LogN 11): its error per
     module;
  10. the naive BSGS oracle (crypto/lintrans.py) on the MLP's first layer
     on configs/mlp.yml, cuda ciphertexts equal to cpu ones and decrypting
     to the scan transform's within the MAE bound; ModMatmulPlan (int8
     digit planes through torch._int_mm) equal to the exact product;
  7. (run after phase 8, whose batches it takes) the key-switch kernels
     batched as the forwards of phases 3, 4, 4b-4d, 6, 6b, 6c and 8 batch
     them: ks_decompose over B polys, ks_finish and ks_finish_raw over a
     pack of K keys (shared ext), over K paired items and, for phase 8's
     MLP and LoLA-CI at B = 8 and ResNet-20 at B = 2, over K items grouped
     by query (K / E keys, ext k % E), B and K the largest batch of that
     level in that config's forward (4 where it has none; for the bootstrapped
     nets each kernel's lowest and highest batched level and the level of
     its largest batch, `batched_levels`, a shape run for one of
     them not run again; for phase 8 the
     level of its largest ks_finish launch), bit-exact against the plain versions, with ms per launch,
     per key-switch and the bound per launch; then every kernel once at
     LogN 14 (configs/mlp.yml's chain on a ring of 2^14), the
     instantiation that needs more than 48 KB of shared memory;
  12. (run after phase 7) the parallel layer on torch.distributed, in
     worlds of processes spawned on cuda:0 and joined by gloo (NCCL
     refuses two ranks on one device; gloo carries the CUDA tensors
     through host memory), each rank loading the libraries phase 1 built:
     the limb-sharded key-switch (parallel/limbshard.py) at M = 2, 4, 8
     at every level of configs/mlp.yml where M divides n_t and at M = 2
     at levels 1, 7, 17, 43 of configs/resnet.yml, bit-exact against the
     unsharded key-switch on the card, through ShardedKS.fn and through
     the forward's seam; the sharded C entries (ks_convert_rows,
     ks_inner_rows, ks_moddown_rows: one launch of ks_decompose's or
     ks_finish's kernels on a rank's rows) each against its plain version
     on every rank's block, timed at mlp level 5 and resnet level 43 with
     each rank alone on the card, beside the rank's kernels of one
     sharded key-switch and the unsharded one (device ms), the sharded
     key-switch's wall and the bytes of its collectives; the full-width
     MLP through make_sharded_forward at (dp = 2, limb = 2), equal to
     make_batched_forward's outputs bit for bit, MAE < 0.005, its
     per-rank launches (the sharded entries and ntt_inv, no ks_decompose
     or ks_finish) and walls; the dp x mp step (parallel/mesh.py) and
     dryrun_boot_mesh at limb = 2, each call these two sharded forwards
     make to the sharded entries held against its plain version
     (`EntryCapture`: batches, key packs, trimmed and lean keys, raw,
     uneven blocks); a 1-rank world on init_multihost's defaults (NCCL):
     M = 1 and dryrun_model_mesh (`check_parallel`);
  11. one JSON line per path (phase 8's batches among them), one for the
     bootstrap, one for phase 8b, one for each of phases 6's noise and
     resident forwards, 9, 9b and 10, one for phase 12, one describing
     each kernel (the sharded entries with their launches in phase 12's
     sharded MLP forward by rank), the card's line, then the result
     line.

Every profiled forward also counts its host-to-device copies (device
records) and the host's stream synchronisations (runtime calls).  Its
device time is the union of its device records' intervals: rescale_poly's
launch B overlaps the end of its launch A; each kernel's time is the sum
of its own records.

Imports only torch, numpy, yaml and orion_tpu_torch.
"""

import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import yaml

ROOT = Path(__file__).resolve().parent
CONFIGS = {tag: ROOT / "configs" / f"{tag}.yml"
           for tag in ("mlp", "lenet", "resnet", "alexnet", "vgg", "lola",
                       "lola2")}
# orion_tpu's own MLP/LoLA test config: the ConjugateInvariant ring, LogN 12
CONFIGS["mlp_ci"] = ROOT / "tests" / "configs" / "mlp.yml"


def cfg_name(tag):
    """The config file of a tag, as the repo names it (mlp14: mlp.yml's
    chain on a ring of 2^14; mlp_b8: mlp.yml's batch of 8 queries)."""
    base = tag.removesuffix("14").split("_b")[0]
    return str(CONFIGS[base].relative_to(ROOT))
# the bootstrapped paths: their configs share resnet.yml's ckks and boot
# parameters, so phase 2's resnet cases hold every kernel at their levels
BOOTSTRAPPED = ("resnet", "alexnet", "vgg")
MEM_RATE = 3.35e12     # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
# 32-bit integer multiplies (IMAD, IMAD.HI) per second: 64 per clock per SM
# on compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput) x 132 SMs x 1.98 GHz boost; a quarter of the data
# sheet's 67 TFLOP/s float32, which counts 128 lanes and 2 flops per FMA
OP_RATE = 64 * 132 * 1.98e9


def fail(msg):
    """Say why on both streams (a caller that keeps only the end of one
    still sees it) and exit 1."""
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters):
    """Mean ms per call over `iters` back-to-back calls after warm-up, from
    CUDA events: the device's time, or the host's where issuing the calls
    takes longer than running them."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_SLEEP = {"cycles": 1 << 24}


def device_ms(fn, iters):
    """Mean device time per call over `iters` calls, launch gaps included
    and the host's issue time left out: the calls are queued behind a
    sleep kernel long enough for the host to issue them all, and CUDA
    events around them time the device alone (the sleep is doubled until
    it outlasts the issuing)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    while True:
        sleep_s = _sleep_s()
        t0 = time.perf_counter()
        torch.cuda._sleep(_SLEEP["cycles"])
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        issue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        # the device reached `start` after the sleep; had the host still
        # been issuing then, the events would time the host
        if issue_s < 0.8 * sleep_s:
            return start.elapsed_time(end) / iters
        _SLEEP["cycles"] *= 2
        _SLEEP.pop("s")


def poison_free_memory():
    """Fill the caching allocator's free blocks with -1.  A kernel output
    that misses elements then cannot pass on a stale buffer that an
    earlier call filled with the same values (ks_finish_raw's output is
    ks_finish's work buffer; trimmed and full-chain keys give equal
    results)."""
    torch.cuda.synchronize()
    sizes = sorted((b["size"] for seg in torch.cuda.memory_snapshot()
                    for b in seg["blocks"] if b["state"] == "inactive"),
                   reverse=True)
    held = [torch.full((n // 8,), -1, dtype=torch.int64, device="cuda")
            for n in sizes if n >= 8]
    torch.cuda.synchronize()
    del held


def _sleep_s():
    """Seconds the device spends in one sleep kernel of _SLEEP cycles."""
    if "s" not in _SLEEP:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(_SLEEP["cycles"])
        b.record()
        torch.cuda.synchronize()
        _SLEEP["s"] = a.elapsed_time(b) / 1e3
    return _SLEEP["s"]


# ------------------------------------------------------------------ #
#  Work of one kernel call, for its bound                            #
# ------------------------------------------------------------------ #
# bytes: each input (residues, keys, twiddle tables) read once and each
# output written once, int64, a twiddle and its Shoup companion packed in
# one word (kernels/ntt.py pack_twiddles); ops: 32-bit integer multiplies
# (3 per Shoup product, 4 per Montgomery product), against the card's IMAD
# rate.

# n is a row's stored residues and `lift` the transform size: equal on the
# standard ring, 2n on the ConjugateInvariant ring (rows of n residues,
# transforms on their 2n lift, twiddle tables 2n long).

def _lg(n):
    return n.bit_length() - 1


def fwd_work(n, lift):
    """(Shoup products, twiddle words) of one row's forward transform.  On
    the CI ring only the outputs the ring keeps are needed, the first half
    (the orbit of 5 modulo 2N, bit-reversed): the first stage's lift / 2
    products into the kept half, then a forward of lift / 2 points over
    lift / 2 twiddles."""
    if lift == n:
        return (lift // 2) * _lg(lift), lift
    return (lift // 4) * (_lg(lift) + 1), lift // 2


def inv_work(n, lift):
    """The same for an inverse transform.  On the CI ring only outputs
    i < n are kept: the last stage, which pairs i with i + n, needs no
    product for them."""
    if lift == n:
        return (lift // 2) * _lg(lift), lift
    return (lift // 2) * (_lg(lift) - 1), lift


def ntt_work(rows, table_rows, n, lift=None, inverse=False):
    """`rows` transformed rows over `table_rows` rows of twiddles."""
    lift = lift or n
    prods, words = inv_work(n, lift) if inverse else fwd_work(n, lift)
    nbytes = 8 * rows * n * 2 + 8 * table_rows * words   # data + packed tw
    ops = 3 * rows * prods + 3 * rows * n
    return nbytes, ops


def divisor_intt_work(groups, n_div, n, lift=None):
    """Launch A of a rescale epilogue: the divisor rows (int64) and their
    inverse tables read, the uint32 scratch written."""
    prods, words = inv_work(n, lift or n)
    nbytes = (8 * groups * n_div * n + 8 * n_div * words
              + 4 * groups * n_div * n)
    return nbytes, 3 * groups * n_div * (prods + n)


def lift_ntt_work(groups, n_div, l, n, fbc, lift=None):
    """Launch B: the scratch, acc's (or c's) l target rows and their
    forward tables read, the output written; per coefficient the lift (the
    basis conversion over n_div rows, or the centered lift's reduction),
    the butterflies and the subtract-and-scale."""
    prods, words = fwd_work(n, lift or n)
    nbytes = 4 * groups * n_div * n + 8 * l * words + 16 * groups * l * n
    per = 6 * n_div + 3 if fbc else 3
    return nbytes, groups * l * (n * (per + 3) + 3 * prods)


def drop_work(groups, n_div, l, n, fbc, lift=None):
    """The launch pair of mod_drop_rescale (fbc) or rescale_poly, each
    input once: the divisor rows, the target rows, the packed twiddles of
    both transforms, and the output (the scratch is internal)."""
    a_bytes, a_ops = divisor_intt_work(groups, n_div, n, lift)
    b_bytes, b_ops = lift_ntt_work(groups, n_div, l, n, fbc, lift)
    nbytes = a_bytes + b_bytes - 8 * groups * n_div * n
    return nbytes, a_ops + b_ops


def decompose_work(nl, n_t, dnum, alpha, n, lift=None):
    """The function's work: the inverse's butterflies, one product per
    source coefficient for its n^-1 scale and the conversion's zq = z *
    qhat_inv together (one constant n^-1 * qhat_inv); per target
    coefficient alpha products, one for v * dmod."""
    lift = lift or n
    i_prods, i_words = inv_work(n, lift)
    f_prods, f_words = fwd_work(n, lift)
    # c, ext, the inverse tables of the nl Q rows, the forward of n_t rows
    nbytes = 8 * n * (nl + dnum * n_t) + 8 * (nl * i_words + n_t * f_words)
    ops = (3 * nl * i_prods + 3 * nl * n
           + dnum * n_t * n * (3 * alpha + 3)
           + 3 * dnum * n_t * f_prods)
    return nbytes, ops


def decompose_batch_work(nl, n_t, dnum, alpha, n, batch, lift=None):
    """B polys: data and operations B times, the tables once."""
    nbytes, ops = decompose_work(nl, n_t, dnum, alpha, n, lift)
    lift = lift or n
    tables = 8 * (nl * inv_work(n, lift)[1] + n_t * fwd_work(n, lift)[1])
    return batch * (nbytes - tables) + tables, batch * ops


def finish_work(nl, n_t, dnum, n, lean, items=1, paired=False,
                moddown=True, lift=None, exts=1, keys=None):
    """K items over `keys` keys (K by default) and `exts` ext items (K if
    paired); each key and ext is read once, the tables once."""
    lift = lift or n
    n_sp = n_t - nl
    keys = items if keys is None else keys
    key_words = keys * dnum * 2 * n_t * n * (1 if lean else 2)
    ext_words = (items if paired else exts) * dnum * n_t * n
    ops = items * 2 * dnum * n_t * n * (7 if lean else 3)
    if not moddown:
        return 8 * (ext_words + key_words + items * 2 * n_t * n), ops
    i_prods, i_words = inv_work(n, lift)
    f_prods, f_words = fwd_work(n, lift)
    nbytes = 8 * (ext_words + key_words + items * 2 * nl * n
                  + n_sp * i_words + nl * f_words)
    # the special rows' inverse, its n^-1 scale and ModDown's zq one
    # product per special coefficient, then n_sp + 1 products per Q
    # coefficient
    ops += items * (2 * n_sp * (3 * i_prods + 3 * n)
                    + 2 * nl * n * (3 * n_sp + 3)
                    + 2 * nl * (3 * f_prods + 3 * n))
    return nbytes, ops


def bound(work):
    nbytes, ops = work
    t_mem, t_op = nbytes / MEM_RATE * 1e3, ops / OP_RATE * 1e3
    return (t_mem, "bytes") if t_mem >= t_op else (t_op, "operations")


# ------------------------------------------------------------------ #
#  Phase 2: kernels against their plain versions                     #
# ------------------------------------------------------------------ #

def make_context(cfg, logn=None):
    """The config's context on the card (its ring, or a ring of 2^logn)."""
    from orion_tpu_torch.crypto import CKKSContext
    from orion_tpu_torch.runtime.config import parse_config

    p = parse_config(cfg)
    return CKKSContext(logn=logn or p.logn, logq=p.split_logq, logp=p.logp,
                       logscale=p.logscale, h=p.h, ring_type=p.ring_type,
                       seed=p.seed, device="cuda")


def kernel_names(ctx):
    """The port's kernels as the context's ring runs them: the standard
    ones, or their ConjugateInvariant forms (`*_ci`, counted apart)."""
    from orion_tpu_torch import kernels as k

    ks = ((k.NTT_FWD, k.NTT_INV, k.DROP_INTT, k.RESCALE_NTT, k.KS_DECOMPOSE,
           k.KS_FINISH) if ctx.ci is None else
          (k.NTT_FWD_CI, k.NTT_INV_CI, k.DROP_INTT_CI, k.RESCALE_NTT_CI,
           k.KS_DECOMPOSE_CI, k.KS_FINISH_CI))
    base = ("ntt_fwd", "ntt_inv", "drop_intt", "rescale_ntt",
            "ks_decompose", "ks_finish")
    return {b: kern.name for b, kern in zip(base, ks)}


class Cases:
    """Runs and records kernel-vs-plain cases of one context."""

    def __init__(self, ctx, tag, stats, seed=7, iters=50, plain_iters=3):
        self.ctx, self.tag, self.stats = ctx, tag, stats
        self.iters, self.plain_iters = iters, plain_iters
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator(device="cuda").manual_seed(seed)

    def residues(self, shape, rr_p):
        hi = rr_p.cpu().numpy()[:, None]
        x = self.rng.integers(0, 1 << 62, size=shape, dtype=np.int64)
        return torch.as_tensor(x % hi, device="cuda")

    def device_residues(self, shape, rr_p):
        """Random residues of a large (..., rows, N) array, made on the card
        (row r mod rr_p[r])."""
        x = torch.randint(0, 1 << 62, shape, generator=self.gen,
                          device="cuda")
        return x % rr_p[:, None]

    def case(self, name, level, label, kernel_fn, plain_fn, work, iters=None,
             items=1, plain_iters=None):
        """Bit-exactness and ms per launch; with plain_iters=0 the plain
        version runs once, for the comparison only."""
        iters = self.iters if iters is None else iters
        plain_iters = (self.plain_iters if plain_iters is None
                       else plain_iters)
        want = plain_fn()
        poison_free_memory()
        got = kernel_fn()
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item())
        ok = torch.equal(got, want)
        del got, want
        ms = cuda_ms(kernel_fn, iters)
        dev_ms = device_ms(kernel_fn, iters)
        plain_ms = cuda_ms(plain_fn, plain_iters) if plain_iters else None
        b, by = bound(work)
        per = (f" per_item={ms / items:.5f} device_per_item="
               f"{dev_ms / items:.5f}" if items > 1 else "")
        plain = f" plain_ms={plain_ms:.3f}" if plain_ms is not None else ""
        print(f"  {self.tag:5s} {name:12s} level {level} {label:34s} "
              f"bit-exact={ok} ms={ms:.4f} device_ms={dev_ms:.4f}{per}"
              f"{plain} bound_ms={b:.5f} ({by})", flush=True)
        self.stats.setdefault(name, []).append(dict(
            config=self.tag, level=level,
            label=f"{self.tag} level {level} {label}", items=items, ok=ok,
            err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
            bound_ms=b, bound_by=by))
        if not ok:
            fail(f"{name} {self.tag} level {level} {label} differs from its "
                 f"plain version (max abs err {err})")


def check_kernels(cfg, tag, stats, logn=None, levels=None, iters=50,
                  plain_iters=3, epilogues_only=False):
    """Every kernel, one key-switch per call, at every level of one config
    (or at `levels`, on a ring of 2^logn when given; with
    `epilogues_only` the rescale epilogues alone); records go to
    `stats` (kernel -> list of per-case records).  On a ConjugateInvariant
    config the kernels run with the CI map and are recorded under their
    `*_ci` names; that ring has no fused drop (no drop-down tables)."""
    from orion_tpu_torch.crypto import KeyChest
    from orion_tpu_torch.crypto.keyswitch import RingRows, dev_level
    from orion_tpu_torch.crypto.ntt_pallas import PallasNTT
    from orion_tpu_torch.kernels import keyswitch as kks
    from orion_tpu_torch.kernels import ntt as kntt
    from orion_tpu_torch.kernels import rescale as krs

    ctx = make_context(cfg, logn)
    rk = KeyChest(ctx).relin_key
    cs = Cases(ctx, tag, stats, iters=iters, plain_iters=plain_iters)
    n, lift = ctx.n, ctx.lift_n
    kn = kernel_names(ctx)
    levels = range(ctx.max_level + 1) if levels is None else levels
    ring = "" if ctx.ci is None else f", ConjugateInvariant: 2n = {lift}"
    print(f"phase {2 if logn is None else 7}: kernels vs plain PyTorch on "
          f"the card, {cfg_name(tag)} (N={n}{ring}, levels "
          f"{', '.join(map(str, levels))})", flush=True)
    for level in levels:
        dl = dev_level(ctx, level)
        if epilogues_only:
            if level >= 1:
                check_epilogues(cs, dl, krs, batches=((2,),))
            continue
        nl = level + 1
        n_t = dl.t.p.shape[0]
        dnum = len(dl.digits)
        # the transforms at the shapes the MLP gives them: the fused
        # drop's inverse NTT over [specials, q_l] and forward NTT over
        # q_0..q_{l-1}; at level 0 (no drop) the level's Q rows
        if dl.dropdown is not None:
            inv_rr = dl.kernel_tables["drop_rows"]
            fwd_rr = dl.q.rows(0, level)
        else:
            inv_rr = fwd_rr = dl.q
        # ... and batched over a ciphertext's two polys, as rescale_poly
        # gives them: the inverse over the last Q row, the forward over the
        # rows below it (level 0 never rescales: its single Q row)
        if level >= 1:
            inv_b, fwd_b = dl.q.rows(level, level + 1), dl.q.rows(0, level)
        else:
            inv_b = fwd_b = dl.q
        for kname, plain, rr, batch in (
                ("ntt_fwd", kntt.ntt_fwd_plain, fwd_rr, ()),
                ("ntt_inv", kntt.ntt_inv_plain, inv_rr, ()),
                ("ntt_fwd", kntt.ntt_fwd_plain, fwd_b, (2,)),
                ("ntt_inv", kntt.ntt_inv_plain, inv_b, (2,))):
            rows = rr.p.shape[0]
            a = cs.residues(batch + (rows, n), rr.p)
            kern = getattr(kntt, kname)
            cs.case(kn[kname], level, str(batch + (rows, n)),
                    lambda: kern(a, rr), lambda: plain(a, rr),
                    ntt_work(a.numel() // n, rows, n, lift,
                             inverse=kname == "ntt_inv"))
        if level >= 1:
            check_epilogues(cs, dl, krs)
        c = cs.residues((nl, n), dl.q.p)
        alpha = max(dg.src_hi - dg.src_lo for dg in dl.digits)
        cs.case(kn["ks_decompose"], level, f"({nl}, {n})",
                lambda: kks.ks_decompose(c, dl),
                lambda: kks.ks_decompose_plain(c, dl),
                decompose_work(nl, n_t, dnum, alpha, n, lift))
        ext = kks.ks_decompose(c, dl)
        rows = dl.ksk_rows_idx
        trim = rk.data[:dnum][:, :, rows].contiguous()
        trim_sh = rk.shoup[:dnum][:, :, rows].contiguous()
        for label, kd, ks, trimmed in (
                ("full-chain Shoup", rk.data, rk.shoup, False),
                ("full-chain lean", rk.data, None, False),
                ("trimmed Shoup", trim, trim_sh, True),
                ("trimmed lean", trim, None, True)):
            cs.case(kn["ks_finish"], level, label,
                    lambda: kks.ks_finish(ext, dl, kd, ks, trimmed),
                    lambda: kks.ks_finish_plain(ext, dl, kd, ks, trimmed),
                    finish_work(nl, n_t, dnum, n, ks is None, lift=lift))
        # the inner product alone, as the fused mul_relin gives it
        cs.case(kn["ks_finish"], level, "raw full-chain Shoup",
                lambda: kks.ks_finish_raw(ext, dl, rk.data, rk.shoup),
                lambda: kks.ks_inner(ext, dl, rk.data, rk.shoup),
                finish_work(nl, n_t, dnum, n, False, moddown=False,
                            lift=lift))
    if logn is not None or tag == "resnet":
        return ctx
    profile_epilogues(dev_level(ctx, ctx.max_level), tag, krs)
    if ctx.ci is not None:
        return ctx

    # the PallasNTT counterpart (crypto/ntt_pallas.py), over the limb rows
    # tests/crypto/test_ntt_pallas.py uses and over the whole chain batched
    # as tests/crypto/test_ks_pallas.py runs pallas_ntt4
    pn = PallasNTT(ctx)
    top = ctx.max_level
    for rows, batch in (([0, 1], ()), (list(range(ctx.n_all)), (2,))):
        rr = RingRows.from_ctx(ctx, rows)
        a = cs.residues(batch + (len(rows), n), rr.p)
        label = f"PallasNTT rows {rows[0]}-{rows[-1]} {batch + (len(rows), n)}"
        cs.case("ntt_fwd", top, label, lambda: pn.ntt(a, rows),
                lambda: kntt.ntt_fwd_plain(a, rr),
                ntt_work(a.numel() // n, len(rows), n))
        cs.case("ntt_inv", top, label, lambda: pn.intt(a, rows),
                lambda: kntt.ntt_inv_plain(a, rr),
                ntt_work(a.numel() // n, len(rows), n, inverse=True))
    return ctx


def check_epilogues(cs, dl, krs, batches=((2,), (2, 2))):
    """mod_drop_rescale and rescale_poly at one level >= 1, over one
    ciphertext (2, rows, N) and a batch of two (2, 2, rows, N), or the
    leading shapes `batches`: launch A, launch B (from launch A's scratch)
    and the pair, each against its plain version.  rescale_poly's launch
    B reads c before it waits for the kernel ahead of it, which here is
    itself, the poisoning fill of free memory or the timing's sleep
    kernel: none writes c.  The ConjugateInvariant ring has rescale_poly
    only."""
    n, level, lift = cs.ctx.n, dl.level, cs.ctx.lift_n
    kn = kernel_names(cs.ctx)
    ci = "" if dl.ci is None else "_ci"
    n_t = dl.t.p.shape[0]
    forms = [("rescale", level + 1, dl.q.p, 1, False, kn["rescale_ntt"],
              krs.rescale_lift_ntt, krs.rescale_lift_ntt_plain,
              krs.rescale_poly, krs.rescale_poly_plain)]
    if dl.dropdown is not None:
        n_sp1 = dl.kernel_tables["drop_rows"].p.shape[0]
        forms.insert(0, ("drop", n_t, dl.t.p, n_sp1, True, "drop_ntt",
                         krs.drop_lift_ntt, krs.drop_lift_ntt_plain,
                         krs.mod_drop_rescale, krs.mod_drop_rescale_plain))
    for batch in batches:
        groups = int(np.prod(batch))
        for what, rows, rr_p, n_div, fbc, b_name, b_fn, b_plain, pair, \
                pair_plain in forms:
            x = cs.residues(batch + (rows, n), rr_p)
            drop = what == "drop"
            label = f"{what} {batch + (rows, n)}"
            cs.case(kn["drop_intt"], level, label,
                    lambda: krs.divisor_intt(x, dl, drop),
                    lambda: krs.divisor_intt_plain(x, dl, drop),
                    divisor_intt_work(groups, n_div, n, lift))
            z = krs.divisor_intt(x, dl, drop)
            cs.case(b_name, level, label, lambda: b_fn(x, z, dl),
                    lambda: b_plain(x, z, dl),
                    lift_ntt_work(groups, n_div, level, n, fbc, lift))
            cs.case(f"{what}_pair{ci}", level, label, lambda: pair(x, dl),
                    lambda: pair_plain(x, dl),
                    drop_work(groups, n_div, level, n, fbc, lift))


STRESS_PAIRS = 200


def stress_rescale(cfg, tag, level):
    """Phase 2c: STRESS_PAIRS rescale_poly calls on distinct ciphertexts
    queued back to back, then each output against its plain version.
    Launch B starts beside the end of launch A (programmatic dependent
    launch) and each launch A writes its scratch where the last one did:
    a B that read z before its A had stored it would take the last
    pair's and differ."""
    from orion_tpu_torch.crypto.keyswitch import dev_level
    from orion_tpu_torch.kernels import rescale as krs

    ctx = make_context(cfg)
    dl = dev_level(ctx, level)
    gen = torch.Generator(device="cuda").manual_seed(13)
    shape = (STRESS_PAIRS, 2, level + 1, ctx.n)
    cts = torch.randint(0, 1 << 62, shape, generator=gen,
                        device="cuda") % dl.q.p[:, None]
    # a fresh context's first call at the level: every table launch B
    # reads is built before launch A, so nothing runs between them
    first = krs.rescale_poly(cts[0], dl)
    if not torch.equal(first, krs.rescale_poly_plain(cts[0], dl)):
        fail(f"a fresh context's first rescale_poly at {tag} level {level} "
             f"differs from the plain version")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [krs.rescale_poly(ct, dl) for ct in cts]
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    bad = [i for i, (ct, out) in enumerate(zip(cts, outs))
           if not torch.equal(out, krs.rescale_poly_plain(ct, dl))]
    print(f"phase 2c: {cfg_name(tag)} level {level}: {STRESS_PAIRS} "
          f"rescale_poly pairs back to back on distinct ciphertexts "
          f"{tuple(shape[1:])}: bit-exact={not bad} ({wall_ms:.1f} ms "
          f"for all, host included)", flush=True)
    if bad:
        fail(f"rescale_poly back to back at {tag} level {level}: pairs "
             f"{bad[:10]} differ from the plain version")


def profile_epilogues(dl, tag, krs):
    """One profiled call of each rescale epilogue on a ciphertext must run
    exactly its two kernels on the card: no torch op between them (on the
    ConjugateInvariant ring rescale_poly's, with the CI map)."""
    n = dl.ring_n
    gen = torch.Generator(device="cuda").manual_seed(3)
    forms = [("rescale_poly", dl.q.p, krs.rescale_poly,
              ("drop_intt_rows", "rescale_lift_ntt"))]
    if dl.dropdown is not None:
        forms.insert(0, ("mod_drop_rescale", dl.t.p, krs.mod_drop_rescale,
                         ("drop_intt_rows", "drop_lift_ntt")))
    for name, rows, fn, want in forms:
        x = torch.randint(0, 1 << 62, (2, rows.shape[0], n), generator=gen,
                          device="cuda") % rows[:, None]
        names = device_kernels(lambda: fn(x, dl))
        print(f"  {tag:5s} one profiled {name} call at level {dl.level}: "
              f"{len(names)} device kernels: "
              f"{', '.join(k[:40] for k in names)}", flush=True)
        if len(names) != 2 or not all(w in k for w, k in zip(want, names)):
            fail(f"{name} ran {names} on the card, not its two kernels "
                 f"{want}")
        if dl.ci is not None and not all("true" in k for k in names):
            fail(f"{name} ran {names}: not the kernels' CI forms")


def check_batched(ctx, tag, stats, sizes, levels=None, default=4,
                  lean=False, done=None, queries=None):
    """The key-switch kernels over batches (phase 7).  sizes: {kernel:
    {level: {items per launch: launches}}} from a forward; B and K are the
    largest batch of the level, `default` where the forward has none.
    Keys are a random trimmed pack (K, dnum, 2, n_t, N) made on the card,
    with Shoup companions or, with `lean`, without (the Montgomery path
    bootstrapped configs take): the kernels' arithmetic does not depend on
    the key being a real one.  `done`, shared by configs with one chain
    (the bootstrapped ones), holds the (kernel, level, batch) cases run
    already: the same shapes are not run twice.  With `queries` = E (a
    batched forward of E queries), ks_finish also runs grouped: K items
    over K / E keys, item k reading ext k % E, as rotate_scan batches E
    queries' baby steps."""
    from orion_tpu_torch.crypto.keyswitch import dev_level
    from orion_tpu_torch.kernels import keyswitch as kks

    cs = Cases(ctx, tag, stats, seed=11)
    n, lift = ctx.n, ctx.lift_n
    kn = kernel_names(ctx)
    levels = range(ctx.max_level + 1) if levels is None else levels
    print(f"phase 7: batched key-switch kernels vs plain PyTorch, "
          f"{cfg_name(tag)} (N={n}, transforms of {lift})", flush=True)

    def largest(kernel, level):
        return max(sizes.get(kn[kernel], {}).get(level, {default: 0}))

    # the plain versions are timed once, at the config's largest batch
    # (not again for a batched forward's queries: its config's single
    # forward timed them)
    timed = {} if queries else {k: max(largest(k, lv) for lv in levels)
                                for k in ("ks_decompose", "ks_finish")}

    def plain_once(kernel, size):
        if timed.get(kernel) == size:
            del timed[kernel]
            return 1
        return 0
    for level in levels:
        dl = dev_level(ctx, level)
        nl = level + 1
        n_t = dl.t.p.shape[0]
        dnum = len(dl.digits)
        alpha = max(dg.src_hi - dg.src_lo for dg in dl.digits)
        b = largest("ks_decompose", level)
        k = largest("ks_finish", level)
        seen = [c for c in (("ks_decompose", level, b),
                            ("ks_finish", level, k))
                if done is not None and c in done]
        if seen:
            print(f"  {tag:5s} level {level}: {seen} run above, not again",
                  flush=True)
        if done is not None:
            done |= {("ks_decompose", level, b), ("ks_finish", level, k)}
        if ("ks_decompose", level, b) not in seen:
            c = cs.device_residues((b, nl, n), dl.q.p)
            cs.case(kn["ks_decompose"], level,
                    f"batch B={b} ({b}, {nl}, {n})",
                    lambda: kks.ks_decompose(c, dl),
                    lambda: kks.ks_decompose_plain(c, dl),
                    decompose_batch_work(nl, n_t, dnum, alpha, n, b, lift),
                    iters=20, items=b,
                    plain_iters=plain_once("ks_decompose", b))
            del c
        if ("ks_finish", level, k) in seen:
            continue
        pack = cs.device_residues((k, dnum, 2, n_t, n), dl.t.p)
        pack_sh = None if lean else (pack << 32) // dl.t.p[:, None]
        keys = "lean" if lean else "Shoup"
        ext1 = cs.device_residues((dnum, n_t, n), dl.t.p)
        extk = cs.device_residues((k, dnum, n_t, n), dl.t.p)
        # key slots out of order, as a transform's giants may have them
        idx = torch.randperm(k, generator=cs.gen, device="cuda")
        plain_iters = plain_once("ks_finish", k)
        variants = [(ext1, "shared", idx, 1, k), (extk, "paired", idx, k, k)]
        if queries and k % queries == 0:
            # each of K / E keys for E queries, key slot-major as
            # rotate_scan orders them
            ge = cs.device_residues((queries, dnum, n_t, n), dl.t.p)
            gidx = torch.randperm(k // queries, generator=cs.gen,
                                  device="cuda").repeat_interleave(queries)
            variants.append((ge, f"grouped E={queries}", gidx, queries,
                             k // queries))
        for ext, how, kidx, exts, nkeys in variants:
            for fn, plain, raw in ((kks.ks_finish, kks.ks_finish_plain, ""),
                                   (kks.ks_finish_raw, kks.ks_inner,
                                    "raw ")):
                cs.case(kn["ks_finish"], level,
                        f"{raw}pack K={k} {how} trimmed {keys}",
                        lambda: fn(ext, dl, pack, pack_sh, True, kidx),
                        lambda: plain(ext, dl, pack, pack_sh, True, kidx),
                        finish_work(nl, n_t, dnum, n, lean, items=k,
                                    exts=exts, keys=nkeys,
                                    moddown=not raw, lift=lift),
                        iters=20, items=k, plain_iters=plain_iters)
        del pack, pack_sh, ext1, extk, variants


def batched_levels(sizes):
    """Phase 7's levels of a bootstrapped net: for ks_decompose and
    ks_finish, the level of the forward's largest batch and its lowest
    and highest batched levels (phase 2 holds them one key-switch per
    call at resnet.yml's timed levels and at the first level of each
    digit count)."""
    levels = set()
    for kernel in ("ks_decompose", "ks_finish"):
        by = sizes.get(kernel, {})
        if by:
            levels |= {min(by), max(by),
                       max(by, key=lambda lv: max(by[lv]))}
    return sorted(levels)


# ------------------------------------------------------------------ #
#  Phases 3-4: a network through the user entry points              #
# ------------------------------------------------------------------ #

OUR_KERNELS = ("ntt_fwd_cluster", "ntt_inv_cluster", "ntt_inv_zq",
               "fbc_ntt_digits", "ks_inner_intt", "moddown_rows",
               "hoist_digits", "drop_intt_rows", "drop_lift_ntt",
               "rescale_lift_ntt")
# kernels that no standard-ring forward of phases 3-4 launches: the generic
# transforms serve PallasNTT and ring_ntt, rescale_ntt is rescale_poly's
# second launch (Evaluator.rescale); every multiply of those networks
# rescales through the fused drop (drop_intt, drop_ntt).  On the
# ConjugateInvariant ring (no fused drop) every rescale is rescale_poly's
# pair with the CI map, and the generic transforms' CI forms serve ring_ntt
# (their map runs in the forward inside drop_intt_ci and rescale_ntt_ci,
# the same cluster transforms, and inside the key-switch kernels).
OFF_PATH = {"standard": ("ntt_fwd", "ntt_inv", "rescale_ntt"),
            "conjugate_invariant": ("ntt_fwd_ci", "ntt_inv_ci")}


def ring_kernels(ring):
    """Names of the kernels a forward on this ring may launch (the sharded
    entries only run under a limb group, phase 12)."""
    from orion_tpu_torch import kernels

    ci = ring == "conjugate_invariant"
    return [k.name for k in kernels.KERNELS if k.name.endswith("_ci") == ci
            and k not in kernels.SHARDED]


def launched_grids():
    """Device kernels by name that the port's wrappers launched since the
    counts were last set to 0: ntt_inv_zq is ks_decompose's first grid
    (ntt_inv_cluster its CI form's), moddown_rows ks_finish's last
    (ks_finish_raw has none); on the standard ring hoist_digits runs
    between the two in both; the sharded entries launch one of these
    grids each, ks_convert_rows and ks_moddown_rows after a hoist_digits
    pass.  A kernel's CI form is the same device kernel (its
    `CI = true` instantiation) or, for the key-switch kernels, one named
    after it (`fbc_ntt_digits_ci`, `ks_inner_intt_ci`, `moddown_rows_ci`,
    which the names here match too)."""
    from orion_tpu_torch import kernels as k

    dec = k.KS_DECOMPOSE.launches + k.KS_DECOMPOSE_CI.launches
    fin = k.KS_FINISH.launches + k.KS_FINISH_CI.launches
    # launches with ModDown: three grids each on the standard ring, two on
    # the CI ring, one without
    md = ((k.KS_FINISH.grids - k.KS_FINISH.launches) // 2
          + k.KS_FINISH_CI.grids - k.KS_FINISH_CI.launches)
    sharded = k.KS_CONVERT_ROWS.launches + k.KS_MODDOWN_ROWS.launches
    return {"ntt_fwd_cluster": k.NTT_FWD.grids + k.NTT_FWD_CI.grids,
            "ntt_inv_cluster": (k.NTT_INV.grids + k.NTT_INV_CI.grids
                                + k.KS_DECOMPOSE_CI.grids
                                - k.KS_DECOMPOSE_CI.launches),
            "ntt_inv_zq": k.KS_DECOMPOSE.launches,
            "fbc_ntt_digits": dec + k.KS_CONVERT_ROWS.launches,
            "ks_inner_intt": fin + k.KS_INNER_ROWS.grids,
            "moddown_rows": md + k.KS_MODDOWN_ROWS.launches,
            "hoist_digits": (k.KS_DECOMPOSE.launches
                             + (k.KS_FINISH.grids - k.KS_FINISH.launches) // 2
                             + sharded),
            "drop_intt_rows": k.DROP_INTT.grids + k.DROP_INTT_CI.grids,
            "drop_lift_ntt": k.DROP_NTT.grids,
            "rescale_lift_ntt": k.RESCALE_NTT.grids + k.RESCALE_NTT_CI.grids}


def run_model(cfg, model, device, params=None, steady=0):
    """init_scheme -> fit -> compile -> encode -> encrypt -> he forward ->
    decrypt of `models.<model>` on one device; launch counts of the first
    forward (counts set to 0 just before it).  The weights come from the
    port's seeded generator (or `params`, carried across with
    `load_jax_params`), the input from the synthetic MNIST set."""
    import orion_tpu_torch as orion
    from orion_tpu_torch import kernels, models
    from orion_tpu_torch.runtime.buffers import hbm_report
    from orion_tpu_torch.utils import get_mnist_datasets, mae

    scheme = orion.init_scheme(cfg, device=device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    trainloader, testloader = get_mnist_datasets(batch_size=1)
    net = getattr(models, model)()
    if params is not None:
        models.load_jax_params(net, params)
    inp, _ = next(iter(testloader))
    net.eval()
    out_clear = net(inp).numpy().reshape(-1)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    orion.fit(net, trainloader)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    input_level = orion.compile(net)
    sync()
    compile_s = time.perf_counter() - t0
    ct = orion.encrypt(orion.encode(inp, input_level))
    net.he()

    dev_mib = compile_peak_mib = None
    if cuda:
        dev_mib = torch.cuda.memory_allocated() / 2 ** 20
        compile_peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        torch.cuda.reset_peak_memory_stats()
    runner = scheme.module_runner
    stream = None
    if runner is not None:
        stream = {"spilled_bytes": scheme.spilled_bytes,
                  "hbm_report_bytes": hbm_report(scheme, net)["total"]}
    sync()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = net(ct)
    sync()
    first_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    by_level = kernels.launch_counts_by_level()
    items = kernels.item_counts()
    items_by_level = kernels.item_counts_by_level()
    batches = kernels.batch_sizes()
    if runner is not None:
        stream["resident_bytes"] = runner.resident_bytes
        stream["uploaded_bytes"] = []
    steady_s = []
    for _ in range(steady):
        if runner is not None:
            runner.uploaded_bytes = 0
        t0 = time.perf_counter()
        net(ct)
        sync()
        steady_s.append(time.perf_counter() - t0)
        if runner is not None:
            stream["uploaded_bytes"].append(runner.uploaded_bytes)
    prof = profile_device(lambda: net(ct)) if cuda else None
    out_fhe = out.decrypt().decode().reshape(-1)[: out_clear.size]
    err = mae(out_clear, out_fhe)
    state = {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()}
    return dict(
        out=out, mae=err, first_s=first_s, steady_s=steady_s, counts=counts,
        by_level=by_level, items=items, items_by_level=items_by_level,
        batches=batches,
        params=state, level=input_level, prof=prof, fit_s=fit_s,
        compile_s=compile_s, in_cts=len(ct.cts),
        rotations=len(scheme.lt_evaluator.generated_rotations),
        key_packs=len(scheme.evaluator._key_packs),
        peak_mib=(torch.cuda.max_memory_allocated() / 2 ** 20 if cuda
                  else None),
        dev_mib=dev_mib, compile_peak_mib=compile_peak_mib,
        ring=scheme.ctx.ring_type, n=scheme.ctx.n,
        slots=scheme.ctx.slots, stream=stream)


def check_model(cfg, model, title, stream=False):
    """One path on cuda, then on cpu with the same weights: MAE, launches,
    equal output ciphertexts.  With `stream`, the same path once more on
    cuda with io_mode: stream, whose output must equal the first (see
    `check_stream`).  Returns the path's JSON record."""
    print(f"{title}, device cuda", flush=True)
    gpu = run_model(cfg, model, "cuda", steady=3)
    steady_ms = [s * 1e3 for s in gpu["steady_s"]]
    ring = gpu["ring"]
    ci = ring == "conjugate_invariant"
    print(f"  ring {ring}: N = {gpu['n']}, {gpu['slots']} slots", flush=True)
    print(f"  input level {gpu['level']} ({gpu['in_cts']} ciphertext(s)); "
          f"MAE vs cleartext {gpu['mae']:.3e}; first forward "
          f"{gpu['first_s'] * 1e3:.1f} ms; steady forward "
          f"{', '.join(f'{s:.1f}' for s in steady_ms)} ms", flush=True)
    print(f"  host: fit {gpu['fit_s']:.2f} s, compile {gpu['compile_s']:.2f} "
          f"s; rotation keys {gpu['rotations']}, key packs "
          f"{gpu['key_packs']}; device memory after compile "
          f"{gpu['dev_mib']:.0f} MiB, peak over the forwards "
          f"{gpu['peak_mib']:.0f} MiB", flush=True)
    print(f"  launches in one forward: {gpu['counts']}; key-switch kernels "
          f"by level: {gpu['by_level']}", flush=True)
    print(f"  items in one forward (key-switches; rows for the NTTs): "
          f"{gpu['items']}; key-switch kernels by level: "
          f"{gpu['items_by_level']}", flush=True)
    print(f"  key-switch and rescale batches {{kernel: {{level: {{items per "
          f"launch: launches}}}}}}: {gpu['batches']}", flush=True)
    pr = gpu["prof"]
    c = gpu["counts"]
    drops = gpu["by_level"].get("drop_ntt", {})
    rescale = "rescale_ntt_ci" if ci else "rescale_ntt"
    print(f"  rescale epilogues in one forward: {sum(drops.values())} "
          f"mod_drop_rescale launch pairs (drop_intt + drop_ntt) by level "
          f"{drops}, {c[rescale]} rescale_poly pairs by level "
          f"{gpu['by_level'].get(rescale, {})}; {pr['device_ops']} device "
          f"ops", flush=True)
    if not pr["device_ops"]:
        print("  profiled forward: the profiler saw no device time "
              "(device breakdown not measured)", flush=True)
    print(f"  profiled forward: wall {pr['wall_ms']:.1f} ms, device "
          f"{pr['device_ms']:.2f} ms in {pr['device_ops']} device ops "
          f"(busy share {pr['busy_share']:.3f}), port kernels "
          f"{pr['our_kernels_ms']:.2f} ms ("
          + ", ".join(f"{k} {v:.2f}" for k, v in
                      pr["our_kernels_by_name"].items())
          + "); top: "
          + "; ".join(f"{k} {v:.2f} ms" for k, v in pr["top"]), flush=True)
    report_profile(pr, model)
    if not gpu["mae"] < 0.005:
        fail(f"{model}: MAE {gpu['mae']} >= 0.005")
    mine = ring_kernels(ring)
    idle = [k for k in mine if c[k] == 0 and k not in OFF_PATH[ring]]
    if idle:
        fail(f"kernels not launched by the {model} forward: {idle}")
    other = [k for k, v in c.items() if v and k not in mine]
    if other:
        fail(f"the {model} forward on the {ring} ring launched {other}")
    pairs = (c["drop_intt_ci"] == c["rescale_ntt_ci"] if ci else
             c["drop_intt"] == c["drop_ntt"] + c["rescale_ntt"])
    if not pairs:
        fail(f"{model}: rescale launches do not come in pairs: {c}")

    print(f"{title}, the same flow on device cpu (plain PyTorch path)",
          flush=True)
    t0 = time.perf_counter()
    cpu = run_model(cfg, model, "cpu", params=gpu["params"])
    print(f"  cpu flow {time.perf_counter() - t0:.1f} s; fit "
          f"{cpu['fit_s']:.2f} s, compile {cpu['compile_s']:.2f} s, forward "
          f"{cpu['first_s']:.1f} s; MAE {cpu['mae']:.3e}", flush=True)
    if len(cpu["out"].cts) != len(gpu["out"].cts):
        fail(f"{model}: output ciphertext counts differ between cuda and cpu")
    for a, b in zip(gpu["out"].cts, cpu["out"].cts):
        if not (a.level == b.level and a.scale == b.scale
                and torch.equal(a.data.cpu(), b.data)):
            fail(f"{model}: cuda and cpu output ciphertexts differ")
    print("  cuda and cpu output ciphertexts are equal", flush=True)
    rec_stream = check_stream(cfg, model, title, gpu) if stream else None
    return {"ring": ring, "n": gpu["n"], "slots": gpu["slots"],
            "stream": rec_stream,
            "first_ms": gpu["first_s"] * 1e3, "steady_ms": steady_ms,
            "mae": gpu["mae"], "launches": gpu["counts"],
            "launches_by_level": gpu["by_level"], "items": gpu["items"],
            "items_by_level": gpu["items_by_level"],
            "batches": gpu["batches"], "fit_s": gpu["fit_s"],
            "compile_s": gpu["compile_s"],
            "rotation_keys": gpu["rotations"], "key_packs": gpu["key_packs"],
            "peak_device_mib": gpu["peak_mib"],
            "cpu_forward_s": cpu["first_s"], "profile": gpu["prof"]}


def stream_line(st):
    """The streaming numbers of one path, for its printed line."""
    up = ", ".join(f"{b / 2 ** 20:.1f}" for b in st["uploaded_bytes"])
    return (f"spilled at compile {st['spilled_bytes'] / 2 ** 20:.1f} MiB "
            f"(hbm_report total {st['hbm_report_bytes'] / 2 ** 20:.1f} "
            f"MiB), resident after the first forward "
            f"{st['resident_bytes'] / 2 ** 20:.1f} MiB, uploaded per "
            f"steady forward {up} MiB")


def check_stream(cfg, model, title, gpu):
    """The path of `gpu` (a run_model record on cuda) compiled again with
    io_mode: stream, from the same weights and seed: its output
    ciphertexts must equal the first run's bit for bit.  Prints the
    compile peak and the memory after compile beside the first run's,
    the bytes spilled and the hbm_report total, what the first forward
    promoted and what each steady forward uploaded."""
    from orion_tpu_torch.nn import linear

    cfg = {**cfg, "orion": {**cfg.get("orion", {}), "io_mode": "stream"}}
    print(f"{title}, again with io_mode stream (device cuda)", flush=True)
    gc.collect()
    # the net built here draws from the port's weight generator: put its
    # state back, so the later phases' nets get the weights they had
    # before this run was added
    rng = linear._WEIGHT_RNG
    state = rng.bit_generator.state
    run = run_model(cfg, model, "cuda", params=gpu["params"], steady=2)
    rng.bit_generator.state = state
    st = run["stream"]
    print(f"  compile peak {run['compile_peak_mib']:.0f} MiB, device memory "
          f"after compile {run['dev_mib']:.0f} MiB (io_mode none "
          f"{gpu['compile_peak_mib']:.0f} and {gpu['dev_mib']:.0f} MiB); "
          f"{stream_line(st)}; forwards {run['first_s'] * 1e3:.1f} ms, "
          f"steady {', '.join(f'{s * 1e3:.1f}' for s in run['steady_s'])} "
          f"ms (io_mode none first {gpu['first_s'] * 1e3:.1f} ms)",
          flush=True)
    if not _same_cts(run["out"], gpu["out"]):
        fail(f"{model}: the io_mode stream output differs from io_mode "
             f"none's")
    print("  the streamed output ciphertexts equal io_mode none's",
          flush=True)
    return {**st, "compile_peak_mib": run["compile_peak_mib"],
            "device_mib_after_compile": run["dev_mib"],
            "first_ms": run["first_s"] * 1e3,
            "steady_ms": [s * 1e3 for s in run["steady_s"]]}


# ------------------------------------------------------------------ #
#  Phase 5: one bootstrap on configs/resnet.yml, cuda against cpu    #
# ------------------------------------------------------------------ #

def run_bootstrap(cfg, device, repeats=0):
    """A fresh scheme on `device`, its full-slot bootstrapper, and one
    bootstrap of a message in [-1, 1] encrypted at the base level, all
    from the config's seed.  Launch and item counts are those of the first
    bootstrap (counts set to 0 just before it)."""
    from orion_tpu_torch import kernels
    from orion_tpu_torch.runtime.scheme import Scheme

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    sch = Scheme().init_scheme(cfg, device=device)
    btp = sch.bootstrapper.generate_bootstrapper(sch.ctx.slots)
    sync()
    build_s = time.perf_counter() - t0
    x = np.random.default_rng(17).uniform(-1, 1, sch.ctx.slots)
    ct = sch.encryptor.encrypt(
        sch.encoder.encode(x, level=sch.params.base_level)).cts[0]
    mem_mib = torch.cuda.memory_allocated() / 2 ** 20 if cuda else None
    sync()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = btp.bootstrap(ct)
    sync()
    first_s = time.perf_counter() - t0
    counts, items = kernels.launch_counts(), kernels.item_counts()
    steady_s = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        btp.bootstrap(ct)
        sync()
        steady_s.append(time.perf_counter() - t0)
    prof = profile_device(lambda: btp.bootstrap(ct)) if cuda else None
    raw = sch.keys.decrypt_rns(out.data.cpu().numpy())
    err = float(np.max(np.abs(sch.enc.decode(raw, out.scale) - x)))
    return dict(out=out, err=err, build_s=build_s, first_s=first_s,
                steady_s=steady_s, prof=prof, counts=counts,
                items=items, mem_mib=mem_mib, top=btp.top,
                out_level=out.level,
                rotations=len(sch.lt_evaluator.generated_rotations),
                key_packs=len(sch.evaluator._key_packs))


def check_bootstrap(cfg):
    print("phase 5: one bootstrap on configs/resnet.yml, device cuda",
          flush=True)
    gpu = run_bootstrap(cfg, "cuda", repeats=1)
    steady_ms = [t * 1e3 for t in gpu["steady_s"]]
    print(f"  build {gpu['build_s']:.1f} s ({gpu['rotations']} rotation "
          f"keys, {gpu['key_packs']} lean key packs, device memory "
          f"{gpu['mem_mib']:.0f} MiB); level {gpu['top']} -> "
          f"{gpu['out_level']}; max error vs the input {gpu['err']:.3e}",
          flush=True)
    pr = gpu["prof"]
    print(f"  one bootstrap: first {gpu['first_s'] * 1e3:.1f} ms, steady "
          f"{', '.join(f'{t:.1f}' for t in steady_ms)} ms; launches "
          f"{gpu['counts']}; items (key-switches; rows for the NTTs) "
          f"{gpu['items']}", flush=True)
    print(f"  profiled bootstrap: wall {pr['wall_ms']:.1f} ms, device "
          f"{pr['device_ms']:.1f} ms in {pr['device_ops']} device ops "
          f"(busy share {pr['busy_share']:.3f}), port kernels "
          f"{pr['our_kernels_ms']:.1f} ms; top: "
          + "; ".join(f"{k} {v:.2f} ms" for k, v in pr["top"]), flush=True)
    report_profile(pr, "bootstrap")
    idle = [k for k in ring_kernels("standard") if gpu["counts"][k] == 0]
    if idle:
        fail(f"kernels not launched by the bootstrap: {idle}")
    if not gpu["err"] < 0.05:
        fail(f"bootstrap error {gpu['err']} against its input")
    print("phase 5: the same bootstrap on device cpu (plain PyTorch path) "
          f"in a process of its own, {CPU_BOOT_THREADS} threads, while "
          "phase 6 runs", flush=True)
    rec = {"err": gpu["err"], "first_ms": gpu["first_s"] * 1e3,
           "steady_ms": steady_ms, "profile": gpu["prof"],
           "launches": gpu["counts"], "items": gpu["items"],
           "keyswitches": gpu["items"]["ks_finish"],
           "build_s": gpu["build_s"], "rotation_keys": gpu["rotations"],
           "key_packs": gpu["key_packs"]}
    return rec, (gpu["out"], spawn_cpu_bootstrap(cfg))


# the host's cores: the card's phases drive it from one, the plain
# bootstrap takes this many of the rest
CPU_BOOT_THREADS = 4


def cpu_bootstrap(cfg, path):
    """Phase 5's bootstrap on device="cpu", its output saved to `path`
    (the body of the process `spawn_cpu_bootstrap` starts)."""
    torch.set_num_threads(CPU_BOOT_THREADS)
    t0 = time.perf_counter()
    cpu = run_bootstrap(cfg, "cpu")
    out = cpu["out"]
    torch.save({"data": out.data, "level": out.level,
                "scale": float(out.scale),
                "err": cpu["err"], "build_s": cpu["build_s"],
                "first_s": cpu["first_s"],
                "whole_s": time.perf_counter() - t0}, path)


def spawn_cpu_bootstrap(cfg):
    """Start `cpu_bootstrap` in a process of its own; returns (process,
    output path) for `join_cpu_bootstrap`."""
    import multiprocessing

    path = ROOT / "build" / "orion_tpu_torch" / "cpu_bootstrap.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    proc = multiprocessing.get_context("spawn").Process(
        target=cpu_bootstrap, args=(cfg, str(path)), daemon=True)
    proc.start()
    return proc, path


def join_cpu_bootstrap(rec, pending, timeout_s=600):
    """Wait for the plain bootstrap and hold its output ciphertext against
    the card's (phase 5's end)."""
    a, (proc, path) = pending
    t0 = time.perf_counter()
    proc.join(timeout_s)
    if proc.is_alive():
        proc.kill()
        proc.join()
        fail(f"bootstrap: the cpu process ran past {timeout_s} s")
    if proc.exitcode != 0 or not path.exists():
        fail(f"bootstrap: the cpu process exited {proc.exitcode}")
    b = torch.load(path)
    print(f"phase 5: cpu: build {b['build_s']:.1f} s, bootstrap "
          f"{b['first_s']:.1f} s, whole {b['whole_s']:.1f} s "
          f"({CPU_BOOT_THREADS} threads, beside phase 6; waited "
          f"{time.perf_counter() - t0:.1f} s for it); max error "
          f"{b['err']:.3e}", flush=True)
    if not (a.level == b["level"] and float(a.scale) == b["scale"]
            and torch.equal(a.data.cpu(), b["data"])):
        fail("bootstrap: cuda and cpu output ciphertexts differ")
    print("phase 5: cuda and cpu output ciphertexts are equal", flush=True)
    rec["cpu_bootstrap_s"] = b["first_s"]


# ------------------------------------------------------------------ #
#  Phase 6: ResNet-20 on configs/resnet.yml                          #
# ------------------------------------------------------------------ #

# the host idles this long on each side of a profiled call, so the
# warm-up call's last kernels end well before the recorded call's first
PROFILE_PAD_S = 0.05
# a sleep kernel this many cycles long marks each end of the recorded call
# on the stream: the call's device records are those between the two
MARK_CYCLES = 1000
# profiles taken of one call at most, while they lose records
PROFILE_ATTEMPTS = 2
# ... of one short call (a fraction of a second each): the CI rescale pair
# at a 2^14 lift lost a marker in 2 of 2 profiles in one run, in 1 of 2 in
# another, and in none in others
SHORT_PROFILE_ATTEMPTS = 6


def profiled(fn, activities):
    """A warm-up call of fn, then one call recorded by torch.profiler with
    the host idle PROFILE_PAD_S before and after it and a marker sleep
    kernel queued just before and just after it.  Returns the profile,
    the recorded call's wall ms (host clock, pads left out) and the
    port's device kernels its wrappers launched in that call."""
    from torch.profiler import profile, schedule

    from orion_tpu_torch import kernels

    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for step in range(2):
            if step:
                time.sleep(PROFILE_PAD_S)
                torch.cuda._sleep(MARK_CYCLES)
            kernels.reset_launches()
            t0 = time.perf_counter()
            fn()
            if step:
                torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            launched = launched_grids()
            if step:
                time.sleep(PROFILE_PAD_S)
            prof.step()
    return prof, wall_ms, launched


class Record(NamedTuple):
    """One profiler record: name, start and end (ns), on the device."""
    name: str
    start: int
    end: int
    device: bool


def records(prof):
    """The profile's records, read from its raw kineto events: building
    torch's FunctionEvent list (`prof.events()`) takes tens of seconds
    for the 230k device records of a ResNet-20 forward."""
    cuda = torch.autograd.DeviceType.CUDA
    return [Record(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                   e.device_type() == cuda)
            for e in prof.profiler.kineto_results.events()]


def call_records(recs):
    """The recorded call's device records among a profile's `records`:
    those that run between the two marker sleep kernels (the port runs on
    one stream, so its records of the call lie between them and those of
    the warm-up call before the first).  Returns them with the records
    left out, counted as the port's kernels or other, and as overlapping
    the call's span (a record of another stream, or one the profiler
    misplaced); None if the markers were not both recorded."""
    recs = [e for e in recs
            if e.device and not e.name.startswith("ProfilerStep")]
    marks = sorted((e for e in recs if "spin_kernel" in e.name),
                   key=lambda e: e.start)
    if len(marks) != 2:
        return None
    lo, hi = marks[0].end, marks[1].start
    kept, left = [], {"port": 0, "other": 0, "overlapping": 0}
    for e in recs:
        start, end = e.start, e.end
        if any(e is m for m in marks):
            continue
        if lo <= start and end <= hi:
            kept.append(e)
            continue
        left["port" if any(o in e.name for o in OUR_KERNELS)
             else "other"] += 1
        left["overlapping"] += start < hi and end > lo
    return kept, left


def busy_ms(recs):
    """ms in which at least one of the device records ran: the union of
    their intervals.  A programmatic dependent launch (rescale_poly's
    launch B) runs beside the end of the kernel ahead of it, so the sum of
    the records' durations would count that overlap twice."""
    total, end = 0, None
    for e in sorted(recs, key=lambda e: e.start):
        if end is None or e.start >= end:
            total += e.end - e.start
            end = e.end
        elif e.end > end:
            total += e.end - end
            end = e.end
    return total / 1e6


def device_kernels(fn):
    """Names of the device kernels one call of fn ran, from a CUDA-only
    torch.profiler profile (a first call warms the profiler up and is not
    recorded), taken again while its markers are missing, up to
    SHORT_PROFILE_ATTEMPTS profiles.  (A CPU and CUDA profile of a rescale
    recorded no device event at all once, after phase 2's thousand
    resnet cases.)"""
    from torch.profiler import ProfilerActivity

    for attempt in range(1, SHORT_PROFILE_ATTEMPTS + 1):
        recs = records(profiled(fn, [ProfilerActivity.CUDA])[0])
        got = call_records(recs)
        if got is not None:
            return [e.name for e in got[0]]
        recs = sorted(recs, key=lambda e: e.start)
        print(f"  profile {attempt} of {SHORT_PROFILE_ATTEMPTS}: the "
              f"markers around the call were not recorded; device records "
              f"by start: "
              + ", ".join(e.name[:40] for e in recs if e.device),
              flush=True)
    fail("the profiler did not record the two marker kernels around a call")


def profile_device(fn):
    """Device time of one call of fn by kernel from a CUDA-only profile (a
    deep forward makes too many host events to keep), after a warm-up
    call that is not recorded: the call's device ms (the union of its
    records' intervals, `busy_ms`) and each kernel's summed durations;
    the port's kernels recorded by name beside
    those their wrappers launched in the recorded call.  A profile whose
    markers are missing, that lost records of the port's kernels or that
    left out a record overlapping the call is said so and taken again, up
    to PROFILE_ATTEMPTS profiles; `report_profile` fails unless the last
    one is whole.  (`device_ms` cannot time a call of thousands of
    launches: they fill the launch queue behind its sleep kernel.)"""
    from torch.profiler import ProfilerActivity

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        prof, wall_ms, launched = profiled(fn, [ProfilerActivity.CUDA])
        t0 = time.perf_counter()
        recs = records(prof)
        got = call_records(recs)
        kept, left = got if got else ([], None)
        by_name, seen = {}, dict.fromkeys(OUR_KERNELS, 0)
        for e in kept:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + (e.end - e.start) / 1e6)
            for o in OUR_KERNELS:
                seen[o] += o in e.name
        if seen == launched and left and not left["overlapping"]:
            break
        print(f"  profile {attempt} of {PROFILE_ATTEMPTS} is not whole: "
              f"port kernels recorded {seen}, launched {launched}; "
              + ("markers not recorded" if left is None
                 else f"records left out {left}"), flush=True)
    dev_ms = busy_ms(kept)
    ours_by = {o: sum(v for k, v in by_name.items() if o in k)
               for o in OUR_KERNELS}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # host-to-device copies among the call's device records; the host's
    # stream synchronisations (runtime calls) in the recorded step, less
    # the harness's own torch.cuda.synchronize after the call (None: the
    # profile recorded no runtime call)
    h2d = sum("HtoD" in e.name for e in kept)
    syncs = sum(not e.device and "Synchronize" in e.name for e in recs)
    return dict(wall_ms=wall_ms, device_ms=dev_ms, h2d_copies=h2d,
                stream_syncs=syncs - 1 if syncs else None,
                our_kernels_ms=sum(ours_by.values()),
                our_kernels_by_name=ours_by, our_kernels_recorded=seen,
                our_kernels_launched=launched, device_ops=len(kept),
                busy_share=dev_ms / wall_ms if wall_ms else None,
                top=[(k[:60], v) for k, v in top], profiles=attempt,
                records_left_out=left, read_s=time.perf_counter() - t0)


def report_profile(pr, what):
    """Print what the profile kept and left out; fail unless it is whole."""
    left = pr["records_left_out"]
    print(f"  port kernels the profile recorded {pr['our_kernels_recorded']}"
          f", launched {pr['our_kernels_launched']} (profile "
          f"{pr['profiles']}; records outside the markers left out: "
          + ("markers not recorded" if left is None else
             f"{left['port']} of port kernels, {left['other']} other, "
             f"{left['overlapping']} overlapping the call")
          + ")", flush=True)
    if left is None or left["overlapping"]:
        fail(f"{what}: the profile could not delimit the recorded call")
    if pr["our_kernels_recorded"] != pr["our_kernels_launched"]:
        fail(f"{what}: the profile lost port kernels, so their device time "
             f"is not measured")


def _same_cts(a, b):
    """Two CipherTensors hold the same ciphertexts: levels, scales and
    residues."""
    return len(a.cts) == len(b.cts) and all(
        x.level == y.level and x.scale == y.scale
        and torch.equal(x.data, y.data) for x, y in zip(a.cts, b.cts))


def _cts_digest(t):
    """sha256 of a cipher tensor's ciphertexts (their residues, on the
    host): two runs' outputs compare by it."""
    import hashlib

    h = hashlib.sha256()
    for ct in t.cts:
        h.update(ct.data.cpu().numpy().tobytes())
    return h.hexdigest()


def check_net(cfg, name, title, build, batch=1, extra=False, turn=None,
              more_steady=0):
    """One bootstrapped net through the user entry points on cuda, from a
    fresh scheme: `build()` makes the net after the weight generator is
    reset to the seed orion_tpu's examples start from, one synthetic
    CIFAR-10 image goes through it.  Prints and returns the path's record:
    host seconds of fit, compile and key generation, rotation keys, key
    packs and their bytes, the bootstraps placed, the ciphertext
    bootstraps of one forward by circuit slot count and by tensor, a first
    and one steady forward, MAE vs cleartext (< 0.005 or the run fails),
    device memory after compile and the peaks of compile and the forwards,
    and a profiled forward that must record every port kernel the
    wrappers launched.  With batch = B > 1 the forward's ciphertext and
    B - 1 more encryptions of its input then go through
    make_batched_forward (phase 8): see `check_net_batch`; the steady
    forward then takes the second of them, and its output is that query's
    serial forward.  With io_mode: stream (the three bootstrapped configs)
    it prints the bytes spilled at compile beside the hbm_report total,
    the bytes promoted by the first forward and uploaded by the steady
    one.  With `extra` (ResNet-20), `check_noise_and_resident` then runs
    the noise profile and the forwards with every buffer resident.  With
    `turn` (a process of its own: `net_process`) it calls turn() after
    the compile and runs the forwards once that returns.  With
    `more_steady` it times that many more steady forwards last."""
    import orion_tpu_torch as orion
    from orion_tpu_torch import kernels
    from orion_tpu_torch.nn import linear
    from orion_tpu_torch.runtime.tensors import CipherTensor
    from orion_tpu_torch.utils import get_cifar_datasets, mae

    print(f"{title}, device cuda", flush=True)
    start_mib = torch.cuda.memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    scheme = orion.init_scheme(cfg, device="cuda")
    # the port draws initial weights from one seeded generator, as
    # orion_tpu does: reset it so the net gets the weights a fresh
    # process builds first (orion_tpu's examples/run_*.py)
    linear._WEIGHT_RNG = np.random.default_rng(2024)
    net = build()
    trainloader, testloader = get_cifar_datasets(batch_size=1)
    inp, _ = next(iter(testloader))
    net.eval()
    out_clear = net(inp).numpy().reshape(-1)

    keygen = {"s": 0.0, "n": 0}
    make_key = scheme.keys.galois_key

    def timed_key(k):
        fresh = k % scheme.ctx.gal_mod not in scheme.keys.galois_keys
        t0 = time.perf_counter()
        key = make_key(k)
        if fresh:
            keygen["s"] += time.perf_counter() - t0
            keygen["n"] += 1
        return key

    scheme.keys.galois_key = timed_key
    t0 = time.perf_counter()
    orion.fit(net, trainloader)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    input_level = orion.compile(net)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    placed = [n for n, m in net.named_modules()
              if getattr(m, "post_bootstrap", None) is not None]
    packs = scheme.evaluator._key_packs.values()
    pack_mib = sum(p.ksk.numel() * 8 + p.perms.numel() * 8
                   for p in packs) / 2 ** 20
    lean = all(p.ksk_shoup is None for p in packs)
    keys_left = len(scheme.keys.galois_keys)
    dev_mib = torch.cuda.memory_allocated() / 2 ** 20
    compile_peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"  host: fit {fit_s:.1f} s, compile {compile_s:.1f} s of which "
          f"key generation {keygen['s']:.1f} s ({keygen['n']} rotation "
          f"keys); input level {input_level}; bootstraps placed "
          f"{len(placed)}: {placed}", flush=True)
    print(f"  key packs {len(scheme.evaluator._key_packs)} (lean {lean}, "
          f"{pack_mib:.0f} MiB), original keys kept {keys_left}; device "
          f"memory before init {start_mib:.0f} MiB, peak during compile "
          f"{compile_peak_mib / 1024:.1f} GiB and after compile "
          f"{dev_mib / 1024:.1f} GiB", flush=True)
    if not lean:
        fail(f"{name}: key packs keep Shoup companions under boot_params")
    if turn is not None:
        turn()
    # io_mode stream (absent from packages before it: --forward-copies)
    runner = getattr(scheme, "module_runner", None)
    stream = None
    if runner is not None:
        from orion_tpu_torch.runtime.buffers import hbm_report
        stream = {"spilled_bytes": scheme.spilled_bytes,
                  "hbm_report_bytes": hbm_report(scheme, net)["total"],
                  "budget_bytes": runner.budget}

    # ciphertext bootstraps of a forward, by circuit slot count, and the
    # ciphertexts of each tensor bootstrapped
    boots = {"slots": {}, "tensors": []}
    service = scheme.bootstrapper
    run_boot, tensor_boot = service.bootstrap, CipherTensor.bootstrap

    def counted(ct, slots):
        s = service.get_for_slots(slots).slots
        boots["slots"][s] = boots["slots"].get(s, 0) + 1
        return run_boot(ct, slots)

    def counted_tensor(self):
        boots["tensors"].append(len(self.cts))
        return tensor_boot(self)

    service.bootstrap = counted
    CipherTensor.bootstrap = counted_tensor
    try:
        ct = orion.encrypt(orion.encode(inp, input_level))
        net.he()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = net(ct)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        items = kernels.item_counts()
        by_level = kernels.launch_counts_by_level()
        batches = kernels.batch_sizes()
        ct_boots = dict(sorted(boots["slots"].items()))
        tensor_boots = list(boots["tensors"])
    finally:
        CipherTensor.bootstrap = tensor_boot
    out_fhe = out.decrypt().decode().reshape(-1)[: out_clear.size]
    err = mae(out_clear, out_fhe)
    print(f"  input {len(ct.cts)} ciphertext(s); MAE vs cleartext "
          f"{err:.3e}; first forward {first_s:.2f} s with "
          f"{sum(ct_boots.values())} ciphertext bootstraps (by circuit "
          f"slots {ct_boots}; ciphertexts per bootstrapped tensor "
          f"{tensor_boots}); launches {counts}; items {items}", flush=True)
    cts = [ct] + [orion.encrypt(orion.encode(inp, input_level))
                  for _ in range(batch - 1)]
    if runner is not None:
        stream["resident_bytes"] = runner.resident_bytes
        stream["device_mib_after_first"] = \
            torch.cuda.memory_allocated() / 2 ** 20
        runner.uploaded_bytes = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steady_out = net(cts[1 if batch > 1 else 0])
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    if runner is not None:
        stream["uploaded_bytes"] = [runner.uploaded_bytes]
        print(f"  io_mode stream: {stream_line(stream)} (budget "
              f"{runner.budget / 2 ** 20:.0f} MiB); device memory after "
              f"the first forward "
              f"{stream['device_mib_after_first'] / 1024:.1f} GiB",
              flush=True)
    pr = profile_device(lambda: net(ct))
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"  steady forward {steady_s:.2f} s; peak device memory over the "
          f"forwards {peak_mib:.0f} MiB", flush=True)
    print(f"  profiled forward: wall {pr['wall_ms']:.0f} ms, device "
          f"{pr['device_ms']:.1f} ms in {pr['device_ops']} device ops "
          f"(busy share {pr['busy_share']:.3f}), port kernels "
          f"{pr['our_kernels_ms']:.1f} ms ("
          + ", ".join(f"{k} {v:.1f}" for k, v in
                      pr["our_kernels_by_name"].items())
          + "); top: "
          + "; ".join(f"{k} {v:.1f} ms" for k, v in pr["top"])
          + f" (profile read in {pr['read_s']:.1f} s); host-to-device "
          f"copies {pr['h2d_copies']}, stream synchronisations "
          f"{pr['stream_syncs']}", flush=True)
    report_profile(pr, name)
    if not err < 0.005:
        fail(f"{name}: MAE {err} >= 0.005")
    idle = [k for k in ring_kernels("standard") if counts[k] == 0]
    if idle:
        fail(f"kernels not launched by the {name} forward: {idle}")
    rec = {"model": name, "mae": err, "input_level": input_level,
           "first_s": first_s, "steady_s": steady_s,
           "bootstraps_placed": len(placed), "placed": placed,
           "ciphertext_bootstraps": sum(ct_boots.values()),
           "ciphertext_bootstraps_by_slots": ct_boots,
           "bootstrapped_tensor_cts": tensor_boots,
           "input_cts": len(ct.cts), "fit_s": fit_s,
           "compile_s": compile_s, "keygen_s": keygen["s"],
           "rotation_keys": keygen["n"],
           "key_packs": len(scheme.evaluator._key_packs),
           "key_pack_mib": pack_mib, "device_mib_before": start_mib,
           "device_mib_after_compile": dev_mib,
           "compile_peak_mib": compile_peak_mib,
           "forward_peak_mib": peak_mib, "launches": counts,
           "items": items, "launches_by_level": by_level,
           "batches": batches, "profile": pr, "stream": stream,
           "out_sha256": _cts_digest(out)}
    if batch > 1:
        rec["batched"] = check_net_batch(scheme, net, name, cts,
                                         [out, steady_out], out_clear, boots,
                                         rec)
    if extra:
        rec["extra"] = check_noise_and_resident(scheme, net, name, inp,
                                                input_level, ct, out,
                                                steady_s)
    if more_steady:
        rec["more_steady_s"] = []
        for _ in range(more_steady):
            t0 = time.perf_counter()
            net(ct)
            torch.cuda.synchronize()
            rec["more_steady_s"].append(time.perf_counter() - t0)
        print(f"  {more_steady} more steady forwards: "
              + ", ".join(f"{t:.2f}" for t in rec["more_steady_s"]) + " s",
              flush=True)
    orion.delete_scheme()
    return rec


def profile_with_output(net, scheme, inp, level, ct):
    """noise_profile of `net` on ciphertext `ct`, and the encrypted
    forward's output (the top-level forward's result, captured around
    it): (records, output, seconds)."""
    from orion_tpu_torch.diagnostics import noise_profile

    seen = []
    forward = net.forward

    def recorded(x):
        seen.append(forward(x))
        return seen[-1]

    net.forward = recorded
    t0 = time.perf_counter()
    try:
        records = noise_profile(net, scheme, inp, level, ctxt=ct)
    finally:
        del net.forward
    return records, seen[-1], time.perf_counter() - t0


def print_profile(name, records, stages=True):
    """The worst stage, the final error, each bootstrap stage's error and,
    with `stages`, one line per stage; fails on a stage that is not
    finite."""
    bad = [r["name"] for r in records
           if not (np.isfinite(r["max_err"]) and np.isfinite(r["rms_err"]))]
    if bad:
        fail(f"{name}: noise profile stages not finite: {bad}")
    worst = max(records, key=lambda r: r["max_err"])
    # a linear stage followed by a BatchNorm stage has the BatchNorm fused
    # into it: its ciphertext holds both while its clear record is the
    # linear map alone, so the like-for-like worst leaves it out
    fused = {a["name"] for a, b in zip(records, records[1:])
             if b["kind"].startswith("BatchNorm")}
    like = max((r for r in records if r["name"] not in fused),
               key=lambda r: r["max_err"])
    boots = [r for r in records if r["kind"] == "Bootstrap"]
    print(f"  noise profile of {name}: {len(records)} stages, every stage "
          f"finite; worst {worst['name']} ({worst['kind']}) max "
          f"{worst['max_err']:.3e}, worst leaving out the {len(fused)} "
          f"stages with a BatchNorm fused in {like['name']} "
          f"({like['kind']}) max {like['max_err']:.3e}; final max "
          f"{records[-1]['max_err']:.3e} rms {records[-1]['rms_err']:.3e}; "
          f"{len(boots)} bootstrap stages", flush=True)
    if boots:
        print("  bootstrap stages (max / rms error): " + "; ".join(
            f"{r['name']} {r['max_err']:.3e} / {r['rms_err']:.3e}"
            for r in boots), flush=True)
    if stages:
        for r in records:
            print(f"    {r['name']:32s} {r['kind']:12s} L{r['ct_level']:>2} "
                  f"max {r['max_err']:.3e} rms {r['rms_err']:.3e} "
                  f"|clear| {r['clear_absmax']:.3e}", flush=True)
    return {"stages": len(records), "worst": worst["name"],
            "worst_max_err": worst["max_err"],
            "worst_unfused": like["name"],
            "worst_unfused_max_err": like["max_err"],
            "final_max_err": records[-1]["max_err"],
            "final_rms_err": records[-1]["rms_err"],
            "bootstraps": {r["name"]: [r["max_err"], r["rms_err"]]
                           for r in boots}}


def check_noise_and_resident(scheme, net, name, inp, level, ct, out,
                             steady_s):
    """On a compiled bootstrapped net (phase 6's ResNet-20): its noise
    profile on the first forward's ciphertext `ct` (every stage finite,
    the profiled forward's output equal to `out` bit for bit), then, under
    io_mode stream, a forward with a budget that holds every buffer (it
    promotes what stayed on the host) and a steady forward with every
    buffer resident, both equal to `out`; their walls beside the streamed
    steady forward's `steady_s`."""
    print(f"phase 6: noise profile of {name} on the ciphertext of its first "
          f"forward", flush=True)
    records, prof_out, prof_s = profile_with_output(net, scheme, inp,
                                                    level, ct)
    if not _same_cts(prof_out, out):
        fail(f"{name}: the profiled forward's output differs from the "
             f"forward's")
    print(f"  profiled forward {prof_s:.1f} s; its output equals the first "
          f"forward's bit for bit", flush=True)
    rec = {"noise": print_profile(name, records), "noise_s": prof_s}
    runner = scheme.module_runner
    if runner is None:
        return rec
    runner.budget = float("inf")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    promoted = net(ct)
    torch.cuda.synchronize()
    promote_s = time.perf_counter() - t0
    runner.uploaded_bytes = 0
    t0 = time.perf_counter()
    resident = net(ct)
    torch.cuda.synchronize()
    resident_s = time.perf_counter() - t0
    if not (_same_cts(promoted, out) and _same_cts(resident, out)):
        fail(f"{name}: the forward with every buffer resident differs from "
             f"the streamed one")
    if runner.host or runner.uploaded_bytes:
        fail(f"{name}: buffers still streamed with an unbounded budget")
    print(f"  every buffer resident (budget unbounded): the promoting "
          f"forward {promote_s:.2f} s, then a steady forward "
          f"{resident_s:.2f} s against {steady_s:.2f} s streamed; "
          f"{runner.resident_bytes / 2 ** 30:.2f} GiB promoted, device "
          f"memory {torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB; "
          f"outputs equal the streamed forward's", flush=True)
    rec.update(promote_s=promote_s, resident_steady_s=resident_s,
               streamed_steady_s=steady_s,
               resident_bytes_all=runner.resident_bytes)
    return rec


def check_net_batch(scheme, net, name, cts, serial, out_clear, boots,
                    single):
    """Phase 8 on a bootstrapped net: the B encryptions `cts` of one input
    through make_batched_forward as one forward.  Each output must equal
    its serial forward bit for bit (`serial` holds those of the first
    queries, the rest are run here), MAE < 0.005.  Prints the batched
    wall, the device-memory peak beside the single forward's, the
    bootstrap calls (each over the B queries) and the key-switch launches
    and items of the batched forward; returns its record."""
    from orion_tpu_torch import kernels
    from orion_tpu_torch.runtime.jit import make_batched_forward
    from orion_tpu_torch.utils import mae

    b = len(cts)
    print(f"phase 8: {name} at B = {b} through make_batched_forward "
          f"(the ciphertext above and {b - 1} more encryption(s) of its "
          f"input)", flush=True)
    serial = serial + [net(c) for c in cts[len(serial):]]
    run = make_batched_forward(net, scheme)
    torch.cuda.reset_peak_memory_stats()
    boots["slots"].clear()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    outs = run(cts)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    items = kernels.item_counts()
    batches = kernels.batch_sizes()
    by_level = kernels.launch_counts_by_level()
    items_by_level = kernels.item_counts_by_level()
    calls = sum(boots["slots"].values())
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    for i, (o, s) in enumerate(zip(outs, serial)):
        if not _same_cts(o, s):
            fail(f"{name}: batched query {i} differs from its serial "
                 f"forward")
    maes = [mae(out_clear, o.decrypt().decode().reshape(-1)
                [: out_clear.size]) for o in outs]
    pr = profile_device(lambda: run(cts))
    print(f"  profiled batched forward: wall {pr['wall_ms']:.0f} ms, "
          f"device {pr['device_ms']:.1f} ms in {pr['device_ops']} device "
          f"ops (busy share {pr['busy_share']:.3f}), port kernels "
          f"{pr['our_kernels_ms']:.1f} ms; single forward above: device "
          f"{single['profile']['device_ms']:.1f} ms, busy share "
          f"{single['profile']['busy_share']:.3f}", flush=True)
    report_profile(pr, f"{name} at B = {b}")
    print(f"  batched forward {wall_s:.2f} s for {b} queries "
          f"({wall_s / b:.2f} s per query; the steady single forward above "
          f"{single['steady_s']:.2f} s); outputs equal the serial forwards "
          f"bit for bit; MAE {', '.join(f'{m:.3e}' for m in maes)}",
          flush=True)
    print(f"  device memory peak of the batched forward {peak_mib:.0f} MiB "
          f"(single forward {single['forward_peak_mib']:.0f} MiB); "
          f"{calls} bootstrap calls over the {b} queries ({calls * b} "
          f"ciphertext bootstraps; single forward "
          f"{single['ciphertext_bootstraps']}); launches {counts}; items "
          f"{items}", flush=True)
    if max(maes) >= 0.005:
        fail(f"{name} at B = {b}: MAE {max(maes)} >= 0.005")
    idle = [k for k in ring_kernels("standard") if counts[k] == 0]
    if idle:
        fail(f"kernels not launched by the batched {name} forward: {idle}")
    return {"model": name, "batch": b, "wall_s": wall_s, "mae": maes,
            "forward_peak_mib": peak_mib,
            "bootstrap_calls": calls, "ciphertext_bootstraps": calls * b,
            "launches": counts, "items": items,
            "launches_by_level": by_level, "items_by_level": items_by_level,
            "batches": batches, "profile": pr}


def check_resnet(cfg, blocks=(3, 3, 3), batch=1, extra=False,
                 more_steady=0):
    """ResNet-20 (or, with blocks (1, 1, 1), the same widths with one
    block per stage), with batch > 1 its batched forward (phase 8), with
    `extra` its noise profile and its forwards with every buffer
    resident, with `more_steady` that many more steady forwards timed."""
    from orion_tpu_torch.models import resnet

    name = "ResNet-20" if tuple(blocks) == (3, 3, 3) else f"ResNet{blocks}"
    rec = check_net(
        cfg, name, f"phase 6: {name} (widths 16/32/64) on configs/resnet.yml",
        lambda: resnet._make("cifar10", resnet.BasicBlock, list(blocks),
                             [16, 32, 64]), batch=batch, extra=extra,
        more_steady=more_steady)
    rec["blocks"] = list(blocks)
    return rec


def check_alexnet(cfg, turn=None):
    """AlexNet at full width: its 192-channel 16x16 tensors span 12
    ciphertexts, and one of them must be bootstrapped."""
    from orion_tpu_torch.models import AlexNet

    rec = check_net(cfg, "AlexNet", "phase 6b: AlexNet (SiLU(127), "
                    "1024-4096-4096-10) on configs/alexnet.yml", AlexNet,
                    turn=turn)
    if 12 not in rec["bootstrapped_tensor_cts"]:
        fail(f"AlexNet: no 12-ciphertext tensor was bootstrapped "
             f"({rec['bootstrapped_tensor_cts']})")
    return rec


def check_vgg(cfg, turn=None):
    """VGG-11 at full width: its last stage fills half the slots, so a
    2048-slot bootstrap circuit must run."""
    from orion_tpu_torch.models import VGG11

    rec = check_net(cfg, "VGG-11", "phase 6c: VGG-11 (minimax ReLU "
                    "(15, 15, 27)) on configs/vgg.yml", VGG11, turn=turn)
    if not rec["ciphertext_bootstraps_by_slots"].get(2048):
        fail(f"VGG-11: no 2048-slot bootstrap ran "
             f"({rec['ciphertext_bootstraps_by_slots']})")
    return rec


# Phases 6b and 6c in processes of their own.  A bootstrapped net's fit
# and compile (host packing and key generation) took most of its phase
# with the card idle, so each net compiles while the card serves the
# phase before it: AlexNet beside phase 6, VGG-11 beside AlexNet's
# forwards (one compile at a time keeps the card's memory and the host's
# cores in bounds).  A net's forwards run alone on the card, in its turn.
NET_CHECKS = {"alexnet": check_alexnet, "vgg": check_vgg}


def net_process(tag, cfg, start, ready, go, path):
    """Phase 6b or 6c in a spawned process: waits for `start`, fits and
    compiles, sets `ready`, waits for `go` (its turn on the card), runs
    the forwards and writes the net's record to `path` (pickle); what it
    prints goes to `path`.log."""
    import pickle

    sys.stdout = sys.stderr = open(f"{path}.log", "w", buffering=1)
    start.wait()

    def turn():
        ready.set()
        go.wait()

    rec = NET_CHECKS[tag](cfg, turn=turn)
    with open(path, "wb") as f:
        pickle.dump(rec, f)


def spawn_nets(cfgs):
    """Start `net_process` for each of NET_CHECKS, each compiling once the
    one before has; returns [(tag, process, (start, ready, go), path)] for
    `join_net` (the events live as long as the processes need them)."""
    import multiprocessing

    out_dir = ROOT / "build" / "orion_tpu_torch" / "nets"
    out_dir.mkdir(parents=True, exist_ok=True)
    mpc = multiprocessing.get_context("spawn")
    start = mpc.Event()
    start.set()
    nets = []
    for tag in NET_CHECKS:
        ready, go = mpc.Event(), mpc.Event()
        path = out_dir / f"{tag}.pkl"
        path.unlink(missing_ok=True)
        proc = mpc.Process(target=net_process, daemon=True,
                           args=(tag, cfgs[tag], start, ready, go,
                                 str(path)))
        proc.start()
        nets.append((tag, proc, (start, ready, go), path))
        start = ready
    return nets


def join_net(tag, proc, events, path, timeout_s=900):
    """Give a net's process its turn on the card, wait for it, print what
    it printed and return its record."""
    import pickle

    events[2].set()
    proc.join(timeout_s)
    if proc.is_alive():
        proc.kill()
        proc.join()
    log = Path(f"{path}.log")
    if log.exists():
        print(log.read_text(), end="", flush=True)
    if proc.exitcode != 0 or not path.exists():
        fail(f"{tag}: its process exited {proc.exitcode}")
    with open(path, "rb") as f:
        return pickle.load(f)


# ------------------------------------------------------------------ #
#  Phase 8: batched serving; phase 8b: key and diagonal I/O          #
# ------------------------------------------------------------------ #

SERVE_STEADY = 5


def check_serving(cfg, model, tag, sizes, title):
    """Phase 8: B queries of `models.<model>` (weights from the port's
    seeded generator, the first B synthetic MNIST test images) through
    make_batched_forward on cuda, for each B in `sizes`.  Each batched
    output must equal the query's serial forward of the same ciphertext
    bit for bit, MAE < 0.005 per query, and every kernel of the path must
    be launched.  Prints the first and steady walls (SERVE_STEADY calls,
    each ending in torch.cuda.synchronize), inferences per second, device
    time and busy share from one profiled batched forward, and key-switch
    launches and items per level.  Returns {f"{tag}_b{B}": record}."""
    import orion_tpu_torch as orion
    from orion_tpu_torch import kernels, models
    from orion_tpu_torch.nn import linear
    from orion_tpu_torch.runtime.jit import make_batched_forward
    from orion_tpu_torch.utils import get_mnist_datasets, mae

    print(f"{title}, device cuda", flush=True)
    scheme = orion.init_scheme(cfg, device="cuda")
    linear._WEIGHT_RNG = np.random.default_rng(2024)
    net = getattr(models, model)()
    trainloader, testloader = get_mnist_datasets(batch_size=1)
    inputs = [x for _, (x, _) in zip(range(max(sizes)), testloader)]
    net.eval()
    clear = [net(x).numpy().reshape(-1) for x in inputs]
    orion.fit(net, trainloader)
    level = orion.compile(net)
    cts = [orion.encrypt(orion.encode(x, level)) for x in inputs]
    net.he()
    net(cts[0])  # the first forward after compile builds lazy tables
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serial = [net(ct) for ct in cts]
    torch.cuda.synchronize()
    serial_ms = (time.perf_counter() - t0) * 1e3 / len(cts)
    ring = scheme.ctx.ring_type
    run = make_batched_forward(net, scheme)
    recs = {}
    for b in sizes:
        batch = cts[:b]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        outs = run(batch)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        counts = kernels.launch_counts()
        by_level = {k: v for k, v in kernels.launch_counts_by_level().items()
                    if k.startswith("ks_")}
        items_by_level = {k: v for k, v in
                          kernels.item_counts_by_level().items()
                          if k.startswith("ks_")}
        batches = kernels.batch_sizes()
        for i, (o, ser) in enumerate(zip(outs, serial)):
            if not _same_cts(o, ser):
                fail(f"{model} B={b}: query {i} differs from its serial "
                     f"forward")
        maes = [mae(c, o.decrypt().decode().reshape(-1)[: c.size])
                for c, o in zip(clear, outs)]
        if max(maes) >= 0.005:
            fail(f"{model} B={b}: MAE {max(maes)} >= 0.005")
        idle = [k for k in ring_kernels(ring)
                if counts[k] == 0 and k not in OFF_PATH[ring]]
        if idle:
            fail(f"kernels not launched by the batched {model} forward: "
                 f"{idle}")
        steady = []
        for _ in range(SERVE_STEADY):
            t0 = time.perf_counter()
            run(batch)
            torch.cuda.synchronize()
            steady.append((time.perf_counter() - t0) * 1e3)
        pr = profile_device(lambda: run(batch))
        med = sorted(steady)[len(steady) // 2]
        print(f"  B={b}: first {first_ms:.1f} ms, steady "
              f"{', '.join(f'{x:.1f}' for x in steady)} ms (median "
              f"{med:.1f} ms: {b / med * 1e3:.1f} inferences/s; serial "
              f"forwards {serial_ms:.1f} ms each); outputs equal the serial "
              f"forwards; max MAE {max(maes):.3e}; profiled: wall "
              f"{pr['wall_ms']:.1f} ms, device {pr['device_ms']:.2f} ms in "
              f"{pr['device_ops']} device ops (busy share "
              f"{pr['busy_share']:.3f}), port kernels "
              f"{pr['our_kernels_ms']:.2f} ms", flush=True)
        print(f"    key-switch launches by level {by_level}; items by level "
              f"{items_by_level}", flush=True)
        report_profile(pr, f"{model} B={b}")
        recs[f"{tag}_b{b}"] = {
            "model": model, "batch": b, "ring": ring, "first_ms": first_ms,
            "steady_ms": steady, "steady_median_ms": med,
            "inferences_per_s": b / med * 1e3,
            "serial_ms_per_query": serial_ms, "mae": maes,
            "launches": counts, "ks_launches_by_level": by_level,
            "ks_items_by_level": items_by_level, "batches": batches,
            "profile": pr}
    orion.delete_scheme()
    return recs


def check_io(cfg, model, tag, none_compile_s, title):
    """Phase 8b: `models.<model>` compiled with io_mode save (keys and
    diagonals written as numpy archives under the build directory), then
    in a fresh scheme with io_mode load from them; the loaded forward of
    the saved run's ciphertext must equal the saved run's forward bit for
    bit.  Prints init_scheme and compile seconds for save and load beside
    phase 3-4's compile with io_mode none (`none_compile_s`), and the
    archives' sizes."""
    import copy

    import orion_tpu_torch as orion
    from orion_tpu_torch import models
    from orion_tpu_torch.native import build_dir
    from orion_tpu_torch.nn import linear
    from orion_tpu_torch.runtime.tensors import CipherTensor
    from orion_tpu_torch.utils import get_mnist_datasets, mae

    print(f"{title}, device cuda", flush=True)
    d = build_dir() / "io"
    keys, diags = d / f"{tag}_keys.npz", d / f"{tag}_diags.npz"
    trainloader, testloader = get_mnist_datasets(batch_size=1)
    inp, _ = next(iter(testloader))
    runs = {}
    ct = None
    for mode in ("save", "load"):
        c = copy.deepcopy(cfg)
        c.setdefault("orion", {}).update(io_mode=mode, keys_path=str(keys),
                                         diags_path=str(diags))
        t0 = time.perf_counter()
        scheme = orion.init_scheme(c, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        linear._WEIGHT_RNG = np.random.default_rng(2024)
        net = getattr(models, model)()
        net.eval()
        clear = net(inp).numpy().reshape(-1)
        orion.fit(net, trainloader)
        t0 = time.perf_counter()
        level = orion.compile(net)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        if ct is None:
            ct = orion.encrypt(orion.encode(inp, level))
        net.he()
        out = net(CipherTensor(scheme, ct.cts, ct.shape, ct.on_shape))
        torch.cuda.synchronize()
        err = mae(clear, out.decrypt().decode().reshape(-1)[: clear.size])
        runs[mode] = dict(init_s=init_s, compile_s=compile_s, mae=err,
                          out=out, level=level)
        orion.delete_scheme()
    a, b = runs["save"]["out"], runs["load"]["out"]
    if runs["save"]["level"] != runs["load"]["level"] \
            or not _same_cts(a, b):
        fail(f"{model}: the forward after io_mode load differs from the "
             f"forward after io_mode save")
    sizes = {"keys_mib": keys.stat().st_size / 2 ** 20,
             "diagonals_mib": diags.stat().st_size / 2 ** 20}
    print(f"  init_scheme + compile: save {runs['save']['init_s']:.2f} + "
          f"{runs['save']['compile_s']:.2f} s, load "
          f"{runs['load']['init_s']:.2f} + {runs['load']['compile_s']:.2f} "
          f"s (compile with io_mode none, phase 3-4: {none_compile_s:.2f} "
          f"s); archives: keys {sizes['keys_mib']:.1f} MiB, diagonals "
          f"{sizes['diagonals_mib']:.1f} MiB; the loaded forward equals the "
          f"saved one bit for bit; MAE {runs['load']['mae']:.3e}",
          flush=True)
    if runs["load"]["mae"] >= 0.005:
        fail(f"{model} after io_mode load: MAE {runs['load']['mae']}")
    return {"model": model,
            "save": {k: runs["save"][k] for k in ("init_s", "compile_s")},
            "load": {k: runs["load"][k] for k in ("init_s", "compile_s",
                                                   "mae")},
            "none_compile_s": none_compile_s, **sizes}


# ------------------------------------------------------------------ #
#  Phase 9: training; 9b: noise profiles; 10: the naive BSGS oracle  #
# ------------------------------------------------------------------ #

# largest difference between the parameters trained on cuda and on cpu,
# relative to each tensor's largest entry: cuDNN's convolutions run in
# TF32 on the card (PyTorch's default, which the trainer leaves as it is)
TRAIN_TOL = 1e-2


def check_training(cfg):
    """Phase 9: LeNet (port's seeded weights) trained for one epoch of the
    synthetic MNIST set at batch 128 (4 SGD steps) on cuda and on cpu
    from the same weights, the largest relative parameter difference
    against TRAIN_TOL; a checkpoint round trip into a fresh LeNet through
    write_back; fit, compile (configs/lenet.yml) and an encrypted forward
    of it on cuda, MAE < 0.005 against the trained net's clear output, and
    its noise profile.  Then ResNet-20 at full width, 4 steps on cuda on
    one batch of 128 synthetic CIFAR-10 images: the training loss on that
    batch must be finite and fall.  Returns the phase's record."""
    import orion_tpu_torch as orion
    from orion_tpu_torch import models
    from orion_tpu_torch import train as tr
    from orion_tpu_torch.native import build_dir
    from orion_tpu_torch.nn import linear
    from orion_tpu_torch.utils import (get_cifar_datasets, get_mnist_datasets,
                                       mae)

    print("phase 9: LeNet trained for one epoch at batch 128 (4 steps) on "
          "cuda and on cpu from the same weights", flush=True)
    linear._WEIGHT_RNG = np.random.default_rng(2024)
    net = models.LeNet()
    ref = models.LeNet()
    ref.load_state_dict(net.state_dict())
    walls = {}
    for dev, m in (("cuda", net), ("cpu", ref)):
        t0 = time.perf_counter()
        tr.train_on_mnist(m, epochs=1, batch_size=128, device=dev,
                          log_every=1)
        if dev == "cuda":
            torch.cuda.synchronize()
        walls[dev] = time.perf_counter() - t0
    a, b = net.state_dict(), ref.state_dict()
    rel = {k: float((a[k] - b[k]).abs().max() / b[k].abs().max())
           for k in b}
    worst = max(rel, key=rel.get)
    print(f"  train wall cuda {walls['cuda']:.2f} s, cpu {walls['cpu']:.2f} "
          f"s (tracing and the test pass included); largest relative "
          f"parameter difference cuda vs cpu {rel[worst]:.3e} ({worst}), "
          f"tolerance {TRAIN_TOL} (TF32 convolutions on the card; cuDNN "
          f"allow_tf32 {torch.backends.cudnn.allow_tf32}, matmul "
          f"allow_tf32 {torch.backends.cuda.matmul.allow_tf32})",
          flush=True)
    if not rel[worst] <= TRAIN_TOL:
        fail(f"LeNet trained on cuda differs from cpu by {rel[worst]} "
             f"({worst})")

    trainloader, testloader = get_mnist_datasets(batch_size=1)
    inp, _ = next(iter(testloader))
    apply, params, state, _ = tr.build_functional(net, inp, device="cuda")
    path = build_dir() / "lenet_trained.npz"
    tr.save_checkpoint(params, path)
    fresh = models.LeNet()
    _, _, _, mods = tr.build_functional(fresh, inp, device="cuda")
    tr.write_back(fresh, tr.load_checkpoint(path), state, mods)
    if not all(torch.equal(fresh.state_dict()[k], v)
               for k, v in net.state_dict().items()):
        fail("LeNet: checkpoint round trip and write_back changed the net")
    print(f"  checkpoint round trip ({path.name}, "
          f"{path.stat().st_size / 2 ** 20:.1f} MiB) and write_back into a "
          f"fresh LeNet: parameters and statistics equal", flush=True)

    scheme = orion.init_scheme(cfg, device="cuda")
    fresh.eval()
    out_clear = fresh(inp).numpy().reshape(-1)
    orion.fit(fresh, trainloader)
    level = orion.compile(fresh)
    ct = orion.encrypt(orion.encode(inp, level))
    fresh.he()
    out = fresh(ct)
    torch.cuda.synchronize()
    err = mae(out_clear, out.decrypt().decode().reshape(-1)[: out_clear.size])
    print(f"  trained LeNet served encrypted on cuda: MAE vs its clear "
          f"output {err:.3e}", flush=True)
    if not err < 0.005:
        fail(f"trained LeNet: MAE {err} >= 0.005")
    print("phase 9b: noise profile of the trained LeNet", flush=True)
    records, prof_out, prof_s = profile_with_output(fresh, scheme, inp,
                                                    level, ct)
    if not _same_cts(prof_out, out):
        fail("LeNet: the profiled forward's output differs")
    rec = {"lenet": {"rel_param_diff": rel[worst], "worst_param": worst,
                     "tolerance": TRAIN_TOL, "train_s": walls, "mae": err,
                     "noise": print_profile("LeNet", records),
                     "noise_s": prof_s}}
    orion.delete_scheme()
    gc.collect()

    print("phase 9: ResNet-20 at full width, 4 SGD steps on cuda on one "
          "batch of 128 synthetic CIFAR-10 images", flush=True)
    linear._WEIGHT_RNG = np.random.default_rng(2024)
    rnet = models.ResNet20()
    x, y = next(iter(get_cifar_datasets(batch_size=128)[0]))
    labels = torch.as_tensor(y, device="cuda")

    def batch_loss():
        apply, params, state, _ = tr.build_functional(rnet, x,
                                                      device="cuda")
        with torch.no_grad():
            logits, _ = apply(params, state, x, train=True)
            return float(torch.nn.functional.cross_entropy(logits, labels))

    before = batch_loss()
    t0 = time.perf_counter()
    tr.train(rnet, [(x, y)] * 4, epochs=1, device="cuda", log_every=1)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    after = batch_loss()
    print(f"  loss on the batch {before:.4f} -> {after:.4f} after 4 steps "
          f"({train_s:.2f} s, tracing included)", flush=True)
    if not (np.isfinite(after) and after < before):
        fail(f"ResNet-20 training: loss {before} -> {after}")
    rec["resnet20"] = {"loss_before": before, "loss_after": after,
                       "train_s": train_s}
    return rec


TINY_VGG_CONFIG = {
    "ckks_params": {"LogN": 11, "LogQ": [29] + [26] * 19, "LogP": [29, 29],
                    "LogScale": 26, "H": 64, "RingType": "Standard"},
    "orion": {"margin": 2, "backend": "tpu", "fuse_modules": True,
              "embedding_method": "hybrid"},
}


def check_tiny_vgg_noise():
    """Phase 9b: the per-module error of `TinyVGG` (two conv blocks with
    SiLU(15), tests/test_torch_models.py) on its LogN-11 config, with the
    weights a fresh process draws and the test's input, on cuda."""
    import orion_tpu_torch as orion
    import orion_tpu_torch.nn as on
    from orion_tpu_torch.nn import linear
    from orion_tpu_torch.utils import ArrayLoader, mae

    class TinyVGG(on.Module):
        def __init__(self):
            super().__init__()
            self.features = on.Sequential(
                on.Conv2d(3, 4, kernel_size=3, padding=1),
                on.BatchNorm2d(4),
                on.SiLU(degree=15),
                on.AvgPool2d(kernel_size=2, stride=2),
                on.Conv2d(4, 8, kernel_size=3, padding=1),
                on.BatchNorm2d(8),
                on.SiLU(degree=15),
                on.AdaptiveAvgPool2d(output_size=2),
            )
            self.flatten = on.Flatten()
            self.classifier = on.Linear(8 * 2 * 2, 4)

        def forward(self, x):
            return self.classifier(self.flatten(self.features(x)))

    print("phase 9b: noise profile of TinyVGG (SiLU(15), LogN 11)",
          flush=True)
    linear._WEIGHT_RNG = np.random.default_rng(2024)
    net = TinyVGG()
    data = np.random.default_rng(3).uniform(
        0, 1, (32, 3, 8, 8)).astype(np.float32)
    inp = data[:1]
    scheme = orion.init_scheme(TINY_VGG_CONFIG, device="cuda")
    net.eval()
    out_exact = net(inp).numpy().reshape(-1)
    orion.fit(net, ArrayLoader(data, np.zeros(len(data)), batch_size=1))
    level = orion.compile(net)
    ct = orion.encrypt(orion.encode(inp, level))
    records, out, prof_s = profile_with_output(net, scheme, inp, level, ct)
    err = mae(out_exact, out.decrypt().decode().reshape(-1)[: out_exact.size])
    print(f"  MAE vs the exact net {err:.4e}; profiled forward "
          f"{prof_s:.1f} s", flush=True)
    rec = {"noise": print_profile("TinyVGG", records), "mae_exact": err}
    orion.delete_scheme()
    return rec


def check_oracle(cfg):
    """Phase 10: the naive BSGS oracle (crypto/lintrans.py) on the first
    layer of the MLP on configs/mlp.yml: its diagonals from a compile on
    cuda, then in fresh contexts on cuda and on cpu (keys from the
    config's seed, made in one order) eval_transform_blocked of one
    encrypted input; the cuda ciphertexts must equal the cpu ones, and
    their decryption the scan transform's (crypto/lintrans_scan.py, on the
    same cuda keys) within the MAE bound.  Then ModMatmulPlan on cuda
    (torch._int_mm) against the exact product."""
    import orion_tpu_torch as orion
    from orion_tpu_torch import models
    from orion_tpu_torch.crypto import (CKKSContext, Encoder, Evaluator,
                                        KeyChest, lintrans, lintrans_scan)
    from orion_tpu_torch.crypto.ciphertext import Ciphertext
    from orion_tpu_torch.crypto.mxu_modmatmul import ModMatmulPlan
    from orion_tpu_torch.utils import get_mnist_datasets, mae

    print("phase 10: the naive BSGS oracle on the MLP's first layer "
          "(configs/mlp.yml), cuda and cpu, against the scan transform",
          flush=True)
    scheme = orion.init_scheme(cfg, device="cuda")
    trainloader, testloader = get_mnist_datasets(batch_size=1)
    net = models.MLP()
    net.eval()
    orion.fit(net, trainloader)
    orion.compile(net)
    fc1 = net.fc1
    diags, level, ratio = fc1.diagonals, fc1.level, fc1.bsgs_ratio
    p = scheme.params
    orion.delete_scheme()
    inp, _ = next(iter(testloader))
    vec = np.asarray(inp, np.float64).reshape(-1)
    rows = 1 + max(i for i, _ in diags)

    def oracle(dev):
        """A fresh context on `dev` (keys from the config's seed, made in
        one order), one encryption of the input, eval_transform_blocked:
        (outputs, the input ciphertext, encoder, keys, evaluator, wall)."""
        ctx = CKKSContext(logn=p.logn, logq=p.split_logq, logp=p.logp,
                          logscale=p.logscale, h=p.h, ring_type=p.ring_type,
                          seed=p.seed, device=dev)
        enc, keys = Encoder(ctx), KeyChest(ctx)
        ev = Evaluator(ctx, keys)
        grid = {blk: lintrans.compile_transform(enc, d, level, ctx.slots,
                                                ratio)
                for blk, d in diags.items()}
        for r in sorted(set().union(*(tr.rotations_needed()
                                      for tr in grid.values()))):
            keys.galois_key(ctx.galois_element(r))
        pt, scale = enc.encode(vec, level=level)
        ct = Ciphertext(ctx.to_device(keys.encrypt_rns(pt)), level, scale)
        t0 = time.perf_counter()
        out = lintrans.eval_transform_blocked(ev, grid, [ct], rows)
        torch.cuda.synchronize()
        return out, ct, enc, keys, ev, time.perf_counter() - t0

    outs, walls = {}, {}
    outs["cuda"], ct, enc, keys, ev, walls["oracle"] = oracle("cuda")
    scan = {blk: lintrans_scan.compile_transform_scan(enc, d, level,
                                                      ev.ctx.slots, ratio)
            for blk, d in diags.items()}
    t0 = time.perf_counter()
    scan_out = lintrans_scan.eval_transform_blocked_scan(ev, scan, [ct],
                                                         rows)
    torch.cuda.synchronize()
    walls["scan"] = time.perf_counter() - t0

    def dec(c):
        return enc.decode(keys.decrypt_rns(c.data.cpu().numpy()), c.scale)

    oracle_dec = np.concatenate([dec(c) for c in outs["cuda"]])
    scan_dec = np.concatenate([dec(c) for c in scan_out])
    outs["cpu"], *_, walls["oracle_cpu"] = oracle("cpu")
    for a, b in zip(outs["cuda"], outs["cpu"]):
        if not (a.level == b.level and a.scale == b.scale
                and torch.equal(a.data.cpu(), b.data)):
            fail("oracle: cuda and cpu ciphertexts differ")
    err = mae(oracle_dec, scan_dec)
    same = all(torch.equal(a.data, b.data) and a.scale == b.scale
               for a, b in zip(outs["cuda"], scan_out))
    n_diags = sum(len(d) for d in diags.values())
    print(f"  {len(diags)} block(s), {n_diags} diagonals at level {level}; "
          f"oracle on cuda {walls['oracle']:.2f} s, on cpu "
          f"{walls['oracle_cpu']:.2f} s, scan transform on cuda "
          f"{walls['scan']:.3f} s; cuda and cpu oracle ciphertexts equal; "
          f"MAE oracle vs scan decryption {err:.3e} (ciphertexts equal: "
          f"{same})", flush=True)
    if not err < 0.005:
        fail(f"oracle: MAE {err} against the scan transform")
    rec = {"blocks": len(diags), "diagonals": n_diags, "level": level,
           "walls_s": walls, "mae_vs_scan": err, "equal_to_scan": same,
           "modmatmul": []}

    q = 1073741789
    for m, n in ((64, 128), (128, 256)):
        rng = np.random.default_rng(m)
        W = rng.integers(0, q, (m, m), dtype=np.int64)
        X = rng.integers(0, q, (m, n), dtype=np.int64)
        plan = ModMatmulPlan(W, q, device="cuda")
        xd = torch.as_tensor(X, device="cuda")
        got = plan(xd).cpu().numpy()
        exact = (W.astype(object) @ X.astype(object)) % q
        ok = np.array_equal(got, exact.astype(np.int64))
        ms = cuda_ms(lambda: plan(xd), 20)
        print(f"  ModMatmulPlan on cuda, p = {q}, (m, n) = ({m}, {n}): "
              f"equal to the exact product {ok}; {ms:.3f} ms per call",
              flush=True)
        if not ok:
            fail(f"ModMatmulPlan ({m}, {n}) differs from the exact product")
        rec["modmatmul"].append({"m": m, "n": n, "exact": ok, "ms": ms})
    return rec


# ------------------------------------------------------------------ #
#  Phase 12: the parallel layer (torch.distributed worlds on cuda:0) #
# ------------------------------------------------------------------ #

# (tag, ranks, backend): the one-card worlds are processes on cuda:0 joined
# by gloo, which carries CUDA tensors through host memory (NCCL refuses two
# ranks on one device); the 1-rank world takes init_multihost's default,
# NCCL on the rank's card
PARALLEL_WORLDS = (("ks2", 2, "gloo"), ("ks4", 4, "gloo"),
                   ("ks8", 8, "gloo"), ("nccl1", 1, None))
PARALLEL_TIMEOUT_S = 300
SHARDED_STEADY = 10


def convert_rows_work(nl, rows, dnum, alpha, n, b=1):
    """ks_convert_rows over b polys: the coefficients of their nl Q rows
    read, the block's ext and its forward tables; per target coefficient
    the conversion, then the NTT; the conversion's zq product once per
    source coefficient."""
    nbytes = 8 * n * (b * nl + b * dnum * rows + rows)
    ops = (b * 3 * nl * n
           + b * dnum * rows * (n * (3 * alpha + 3) + 3 * (n // 2) * _lg(n)))
    return nbytes, ops


def inner_rows_work(rows, sp_rows, dnum, n, lean, items=1, exts=1,
                    moddown=True):
    """ks_inner_rows over `items` key-switches from `exts` ext items: the
    block's ext and each item's key rows read, the work buffer written;
    with moddown the inverse NTT of its special rows (their tables
    read)."""
    sp = sp_rows if moddown else 0
    nbytes = 8 * n * (exts * dnum * rows
                      + items * dnum * 2 * rows * (1 if lean else 2)
                      + items * 2 * rows + sp)
    ops = items * (2 * dnum * rows * n * (7 if lean else 3)
                   + 2 * sp * (3 * (n // 2) * _lg(n) + 3 * n))
    return nbytes, ops


def moddown_rows_work(nq, n_sp, n, items=1):
    """ks_moddown_rows over `items` key-switches: the block's Q rows and
    the summed special rows read, the Q rows written, their forward
    tables; the conversion's zq product once per special coefficient."""
    nbytes = 8 * n * (items * (2 * (nq + n_sp) + 2 * nq) + nq)
    ops = items * 2 * (3 * n_sp * n
                       + nq * (n * (3 * n_sp + 3) + 3 * (n // 2) * _lg(n)
                               + 3 * n))
    return nbytes, ops


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _in_turn(fn):
    """Run fn on each rank of the world in turn, the others waiting at a
    barrier: times taken on the shared card see no other rank's work."""
    import torch.distributed as dist

    out = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            out = fn()
            torch.cuda.synchronize()
        dist.barrier()
    return out


def _sharded_cases(cfg, tag, levels, stats, entries=False, timed=()):
    """The limb-sharded key-switch over the whole world (M ranks) at each
    level of `cfg`: ShardedKS.fn on the key's row blocks and the forward's
    seam on replicated keys must both equal the unsharded `keyswitch` on
    the card.  With `entries`, each new C entry on this rank's block
    against its plain version (its own case line); at the `timed` levels,
    each rank alone in turn: the entries' times, the rank's kernels of one
    sharded key-switch and the unsharded key-switch (device ms), then the
    whole sharded key-switch's wall with every rank in it."""
    import torch.distributed as dist
    from collections import Counter

    from orion_tpu_torch.crypto import KeyChest
    from orion_tpu_torch.crypto.keyswitch import (dev_level, keyswitch,
                                                  set_limb_group)
    from orion_tpu_torch.kernels import keyswitch as kks
    from orion_tpu_torch.kernels.ntt import ntt_inv
    from orion_tpu_torch.parallel import limbshard as ls

    m, rank = dist.get_world_size(), dist.get_rank()
    ctx = make_context(cfg)
    rk = KeyChest(ctx).relin_key
    group = ls.LimbGroup()
    out = []
    for lvl in levels:
        dl = dev_level(ctx, lvl)
        rng = np.random.default_rng(lvl)
        x = ctx.to_device(np.stack([
            rng.integers(0, ctx.primes[i], ctx.n, dtype=np.int64)
            for i in range(lvl + 1)]))
        want = keyswitch(x, dl, rk.data, rk.shoup)
        sks = ls.make_sharded_keyswitch(ctx, lvl)
        kd, kss = sks.shard_ksk(rk.data, rk.shoup, ctx)
        got = sks.gather(sks.fn(sks.put(sks.pad_poly(x)), sks.put(kd),
                                sks.put(kss)))[:, : lvl + 1]
        before = Counter(ls.COLLECTIVES)
        prev = set_limb_group(group)
        try:
            seam = keyswitch(x, dl, rk.data, rk.shoup)
        finally:
            set_limb_group(prev)
        moved = dict(Counter(ls.COLLECTIVES) - before)
        torch.cuda.synchronize()
        ok = torch.equal(got, want) and torch.equal(seam, want)
        err = max(int((got - want).abs().max()), int((seam - want).abs()
                                                     .max()))
        blk = sks.blk
        case = {"config": tag, "level": lvl, "m": m, "rank": rank,
                "n_t": sks.nl + sks.n_sp, "rows": [blk.lo, blk.hi],
                "q_rows": blk.nq, "bit_exact": ok, "max_abs_err": err,
                "collectives": moved}
        print(f"  {tag} level {lvl} M={m} rank {rank}: rows {blk.lo}.."
              f"{blk.hi - 1} ({blk.nq} Q); sharded key-switch bit-exact="
              f"{ok} (ShardedKS.fn and the seam); collectives of one "
              f"key-switch {moved}", flush=True)
        if not ok:
            fail(f"sharded key-switch {tag} level {lvl} M={m} rank {rank} "
                 f"differs from keyswitch (max abs err {err})")
        if entries:
            _entry_cases(ctx, dl, blk, rk, x, tag, lvl, stats, lvl in timed)
        if lvl in timed:
            case["timing"] = _sharded_timing(ctx, dl, blk, rk, x, group)
        out.append(case)
    return out


def _entry_cases(ctx, dl, blk, rk, x, tag, lvl, stats, timed):
    """Each new C entry on this rank's block against its plain version on
    the same inputs (Cases: bit-exact, -1-poisoned memory); at a timed
    level each rank takes its turn alone (every rank passes the
    barriers, one with no rows too)."""
    import torch.distributed as dist

    from orion_tpu_torch.kernels import keyswitch as kks
    from orion_tpu_torch.kernels.ntt import ntt_inv

    rank = dist.get_rank()
    rows, n, dnum = blk.hi - blk.lo, ctx.n, len(dl.digits)

    def run():
        if rows == 0:
            return
        coeff = ntt_inv(x, dl.q)[None]
        rm = dl.kernel_row_map(False)[blk.lo:blk.hi]
        ext = kks.ks_convert_rows_plain(coeff, dl, blk)[0]
        work = kks.ks_inner_rows_plain(ext, dl, blk, rk.data, rk.shoup, rm)
        alpha = max(dg.src_hi - dg.src_lo for dg in dl.digits)
        n_sp = dl.s.p.shape[0]
        gen = torch.Generator(device="cuda").manual_seed(lvl)
        sp = torch.randint(0, 1 << 62, (2, n_sp, n), generator=gen,
                           device="cuda") % dl.s.p[:, None]
        x_md = torch.cat([work[:, :blk.nq], sp], dim=1)[None].contiguous()
        label = f"rank {rank} rows {blk.lo}..{blk.hi - 1}"
        cs = Cases(ctx, f"{tag}/r{rank}", stats,
                   iters=50 if timed else 2, plain_iters=3 if timed else 0)
        cs.case("ks_convert_rows", lvl, label,
                lambda: kks.ks_convert_rows(coeff, dl, blk),
                lambda: kks.ks_convert_rows_plain(coeff, dl, blk),
                convert_rows_work(dl.level + 1, rows, dnum, alpha, n))
        cs.case("ks_inner_rows", lvl, label + " full-chain Shoup",
                lambda: kks.ks_inner_rows(ext, dl, blk, rk.data, rk.shoup,
                                          rm),
                lambda: kks.ks_inner_rows_plain(ext, dl, blk, rk.data,
                                                rk.shoup, rm),
                inner_rows_work(rows, rows - blk.nq, dnum, n, False))
        if blk.nq:
            cs.case("ks_moddown_rows", lvl, label,
                    lambda: kks.ks_moddown_rows(x_md, dl, blk),
                    lambda: kks.ks_moddown_rows_plain(x_md, dl, blk),
                    moddown_rows_work(blk.nq, n_sp, n))

    if timed:
        _in_turn(run)
    else:
        run()


SHARDED_ENTRIES = ("ks_convert_rows", "ks_inner_rows", "ks_moddown_rows")


class EntryCapture:
    """While entered, every call that parallel/limbshard.py makes to a
    sharded C entry runs as usual and its inputs are kept: per form, the
    call with the most items.  A form is the entry, the level and the
    rank's rows, and for ks_inner_rows the ext items, one key or a pack
    (key_index), the key rows (full-chain or trimmed), Shoup or lean keys
    and the ModDown flag.  `replay` then holds each kept call against its
    plain version on the same inputs."""

    def __init__(self):
        self.forms = {}

    def _keep(self, key, items, args):
        if key not in self.forms or self.forms[key][0] < items:
            self.forms[key] = (items, args)

    def __enter__(self):
        from orion_tpu_torch.parallel import limbshard as ls

        self._orig = {n: getattr(ls, n) for n in SHARDED_ENTRIES}
        orig = self._orig

        def convert(coeff, dl, blk):
            self._keep(("ks_convert_rows", dl.level, blk.lo, blk.hi),
                       coeff.shape[0], (coeff.clone(), dl, blk))
            return orig["ks_convert_rows"](coeff, dl, blk)

        def inner(ext, dl, blk, ksk, ksk_shoup, row_map, key_index=None,
                  moddown=True):
            items = 1 if key_index is None else key_index.shape[0]
            form = ("ks_inner_rows", dl.level, blk.lo, blk.hi,
                    ext.shape[0] if ext.dim() == 4 else 0,
                    key_index is not None, ksk.shape[-2],
                    ksk_shoup is None, bool(moddown))
            self._keep(form, items, (
                ext.clone(), dl, blk, ksk, ksk_shoup, row_map.clone(),
                None if key_index is None else key_index.clone(),
                moddown))
            return orig["ks_inner_rows"](ext, dl, blk, ksk, ksk_shoup,
                                         row_map, key_index, moddown)

        def moddown(x, dl, blk):
            self._keep(("ks_moddown_rows", dl.level, blk.lo, blk.hi),
                       x.shape[0], (x.clone(), dl, blk))
            return orig["ks_moddown_rows"](x, dl, blk)

        for n, fn in zip(SHARDED_ENTRIES, (convert, inner, moddown)):
            setattr(ls, n, fn)
        return self

    def __exit__(self, *exc):
        from orion_tpu_torch.parallel import limbshard as ls

        for n, fn in self._orig.items():
            setattr(ls, n, fn)

    def replay(self, tag, stats, m):
        """Each kept call against its plain version (Cases: bit-exact,
        -1-poisoned memory; a few calls timed, every rank on the card at
        once).  m is the limb group's size.  Returns the forms counted by
        entry and the kinds of form seen ("batch", "pack", "paired",
        "raw", "lean", "trimmed", "uneven")."""
        import torch.distributed as dist

        from orion_tpu_torch.kernels import keyswitch as kks

        cs = Cases(None, f"{tag}/r{dist.get_rank()}", stats, iters=2,
                   plain_iters=0)
        by_entry, kinds = dict.fromkeys(SHARDED_ENTRIES, 0), set()
        for key in sorted(self.forms):
            items, args = self.forms[key]
            name, level, lo, hi = key[:4]
            dl, blk = args[1], args[2]
            rows, n, dnum = hi - lo, dl.ring_n, len(dl.digits)
            n_t = dl.t.p.shape[0]
            label = f"rows {lo}..{hi - 1} of {n_t}"
            if n_t % m:
                kinds.add("uneven")
                label += " uneven"
            if name == "ks_convert_rows":
                alpha = max(dg.src_hi - dg.src_lo for dg in dl.digits)
                work = convert_rows_work(dl.level + 1, rows, dnum, alpha, n,
                                         items)
                label += f" B={items}"
                kinds |= {"batch"} if items > 1 else set()
                fn, plain = kks.ks_convert_rows, kks.ks_convert_rows_plain
            elif name == "ks_inner_rows":
                exts, pack, key_rows, lean, md = key[4:]
                full_rows = int(dl.ksk_rows_idx.max()) + 1
                trimmed = key_rows == n_t < full_rows
                label += (f" {'pack K=' if pack else 'one key'}"
                          f"{items if pack else ''} ext "
                          f"{exts if exts else 'shared'} key rows "
                          f"{key_rows}{' trimmed' if trimmed else ''} "
                          f"{'lean' if lean else 'Shoup'}"
                          f"{'' if md else ' raw'}")
                kinds |= {k for k, on in (
                    ("pack", pack), ("paired", exts > 1), ("lean", lean),
                    ("trimmed", trimmed), ("raw", not md)) if on}
                work = inner_rows_work(rows, rows - blk.nq, dnum, n, lean,
                                       items, max(exts, 1), md)
                fn, plain = kks.ks_inner_rows, kks.ks_inner_rows_plain
            else:
                work = moddown_rows_work(blk.nq, dl.s.p.shape[0], n, items)
                label += f" K={items}"
                kinds |= {"batch"} if items > 1 else set()
                fn, plain = kks.ks_moddown_rows, kks.ks_moddown_rows_plain
            cs.case(name, level, label, lambda: fn(*args),
                    lambda: plain(*args), work, items=items)
            by_entry[name] += 1
        return {"forms": by_entry, "kinds": sorted(kinds)}


# the forms of the sharded entries that the sharded MLP forward and the
# sharded bootstrapped forward must have given them between them
ENTRY_KINDS = ("batch", "pack", "raw", "lean", "trimmed", "uneven")


def _check_entry_forms(rank, *cases):
    """Fail unless the captured calls of a rank held every sharded entry
    and every kind of form in ENTRY_KINDS against its plain version."""
    kinds = set().union(*(c["kinds"] for c in cases))
    idle = [e for e in SHARDED_ENTRIES if not any(c["forms"][e]
                                                  for c in cases)]
    missing = [k for k in ENTRY_KINDS if k not in kinds]
    print(f"  rank {rank}: the sharded forwards' entry calls held against "
          f"their plain versions: {[c['forms'] for c in cases]}, kinds "
          f"{sorted(kinds)}", flush=True)
    if idle or missing:
        fail(f"rank {rank}: no captured call of {idle} or of the forms "
             f"{missing}")


def _sharded_timing(ctx, dl, blk, rk, x, group):
    """Device ms of the unsharded key-switch and of this rank's kernels of
    one sharded key-switch (each rank alone in turn), then the sharded
    key-switch's wall (median of SHARDED_STEADY calls, every rank in
    them, each call ending in a synchronisation)."""
    import torch.distributed as dist

    from orion_tpu_torch.crypto.keyswitch import keyswitch, set_limb_group
    from orion_tpu_torch.kernels import keyswitch as kks
    from orion_tpu_torch.kernels.ntt import ntt_inv

    rm = dl.kernel_row_map(False)[blk.lo:blk.hi]
    coeff = ntt_inv(x, dl.q)[None]
    # the ModDown's input: the block's Q rows and n_sp special rows
    x_md = torch.zeros((1, 2, blk.nq + dl.s.p.shape[0], ctx.n),
                       dtype=torch.int64, device="cuda")
    q_rows = x[blk.lo:blk.lo + blk.nq].contiguous()

    def rank_kernels():
        if blk.nq:
            ntt_inv(q_rows, blk.q_rows)
        if blk.hi > blk.lo:
            e = kks.ks_convert_rows(coeff, dl, blk)[0]
            kks.ks_inner_rows(e, dl, blk, rk.data, rk.shoup, rm)
        if blk.nq:
            kks.ks_moddown_rows(x_md, dl, blk)

    def alone():
        return {"unsharded_device_ms": device_ms(
                    lambda: keyswitch(x, dl, rk.data, rk.shoup), 50),
                "unsharded_ms": cuda_ms(
                    lambda: keyswitch(x, dl, rk.data, rk.shoup), 50),
                "rank_kernels_device_ms": device_ms(rank_kernels, 50)}

    rec = _in_turn(alone)
    walls = []
    prev = set_limb_group(group)
    try:
        for _ in range(SHARDED_STEADY + 2):
            dist.barrier()
            t0 = time.perf_counter()
            keyswitch(x, dl, rk.data, rk.shoup)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        set_limb_group(prev)
    walls = sorted(walls[2:])
    rec["sharded_wall_ms"] = walls[len(walls) // 2]
    print(f"  level {dl.level} rank {dist.get_rank()} of "
          f"{dist.get_world_size()}: unsharded key-switch "
          f"{rec['unsharded_device_ms']:.4f} device ms "
          f"({rec['unsharded_ms']:.4f} ms back to back); this rank's "
          f"kernels of a sharded one {rec['rank_kernels_device_ms']:.4f} "
          f"device ms; sharded key-switch wall {rec['sharded_wall_ms']:.3f} "
          f"ms (median of {SHARDED_STEADY}, gloo through host memory)",
          flush=True)
    return rec


def _rank_mlp(cfg, stats, batch=4):
    """The full-width MLP 784-128-128-10 on configs/mlp.yml, B queries
    through make_sharded_forward on a (dp = 2, limb = 2) mesh
    (make_dcn_mesh, one host): equal to make_batched_forward's outputs
    on this rank bit for bit, MAE < 0.005; the launches of the first
    sharded forward (counts set to 0 just before it) must include every
    sharded entry and ntt_inv and no ks_decompose or ks_finish; first and
    steady walls of both forwards.  One more sharded forward keeps the
    inputs of its sharded entries' calls (`EntryCapture`), and each form
    is then held against its plain version."""
    import torch.distributed as dist

    import orion_tpu_torch as orion
    from orion_tpu_torch import kernels, models
    from orion_tpu_torch.nn import linear
    from orion_tpu_torch.parallel import limbshard as ls
    from orion_tpu_torch.parallel.multihost import (make_dcn_mesh,
                                                    mesh_report)
    from orion_tpu_torch.runtime.jit import make_batched_forward
    from orion_tpu_torch.runtime.mesh import (encrypt_batch,
                                              make_sharded_forward)
    from orion_tpu_torch.utils import get_mnist_datasets, mae

    rank = dist.get_rank()
    mesh = make_dcn_mesh(limb=2)
    scheme = orion.init_scheme(cfg, device="cuda")
    linear._WEIGHT_RNG = np.random.default_rng(2024)
    net = models.MLP()
    trainloader, testloader = get_mnist_datasets(batch_size=1)
    inputs = [x for _, (x, _) in zip(range(batch), testloader)]
    net.eval()
    clear = [net(x).numpy().reshape(-1) for x in inputs]
    orion.fit(net, trainloader)
    level = orion.compile(net)
    cts = encrypt_batch(scheme, inputs, level)
    net.he()
    batched = make_batched_forward(net, scheme)
    want = batched(cts)
    run = make_sharded_forward(net, scheme, mesh)
    before = ls.COLLECTIVES.copy()
    torch.cuda.synchronize()
    dist.barrier()
    kernels.reset_launches()
    t0 = time.perf_counter()
    outs = run(cts)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    moved = dict(ls.COLLECTIVES - before)
    same = all(_same_cts(a, b) for a, b in zip(outs, want))
    maes = [mae(c, o.decrypt().decode().reshape(-1)[: c.size])
            for c, o in zip(clear, outs)]
    walls = {"sharded": [], "batched": []}
    for _ in range(3):
        for tag, fn in (("sharded", run), ("batched", batched)):
            dist.barrier()
            t0 = time.perf_counter()
            fn(cts)
            torch.cuda.synchronize()
            walls[tag].append((time.perf_counter() - t0) * 1e3)
    cap = EntryCapture()
    with cap:
        run(cts)
    rec = {"model": "MLP", "batch": batch, "mesh": mesh_report(mesh),
           "equal_to_batched": same, "mae": maes, "first_ms": first_ms,
           "steady_ms": walls, "launches": counts, "collectives": moved,
           "dp_row": mesh.index("dp"), "limb_index": mesh.index("limb"),
           "entry_cases": cap.replay("mlp_fwd", stats, mesh.size("limb"))}
    print(f"  MLP rank {rank} (dp row {rec['dp_row']}, limb "
          f"{rec['limb_index']}): B = {batch} sharded outputs equal to "
          f"make_batched_forward's: {same}; max MAE {max(maes):.3e}; first "
          f"{first_ms:.1f} ms, steady sharded "
          f"{', '.join(f'{w:.1f}' for w in walls['sharded'])} ms against "
          f"batched {', '.join(f'{w:.1f}' for w in walls['batched'])} ms; "
          f"launches {counts}; collectives {moved}", flush=True)
    if not same:
        fail(f"MLP rank {rank}: sharded outputs differ from the batched "
             f"forward's")
    if not max(maes) < 0.005:
        fail(f"MLP rank {rank}: sharded MAE {max(maes)}")
    sharded = [k.name for k in kernels.SHARDED] + ["ntt_inv"]
    idle = [k for k in sharded if not counts.get(k)]
    if idle or counts.get("ks_decompose") or counts.get("ks_finish"):
        fail(f"MLP rank {rank}: the sharded forward launched {counts}")
    orion.delete_scheme()
    return rec


def _rank_dp_mp():
    """encrypted_dp_mp_step at dp = 2, mp = 2 on __graft_entry__'s shapes
    (LogN 8, two member transforms over one diagonal index set) on cuda:
    equal to the same step computed on this rank alone."""
    import torch.distributed as dist

    from orion_tpu_torch.crypto import (CKKSContext, Encoder, Evaluator,
                                        KeyChest, lintrans_scan)
    from orion_tpu_torch.crypto.ciphertext import Ciphertext
    from orion_tpu_torch.crypto.keyswitch import dev_level
    from orion_tpu_torch.crypto.modops import add_mod
    from orion_tpu_torch.parallel.mesh import Mesh, encrypted_dp_mp_step

    ctx = CKKSContext(logn=8, logq=[29, 26, 26, 26], logp=[29, 29],
                      logscale=26, h=64, seed=3, device="cuda")
    enc, keys = Encoder(ctx), KeyChest(ctx)
    ev = Evaluator(ctx, keys)
    rng = np.random.default_rng(0)
    diags = (0, 1, 2, 5, 17, 40)
    trs = [lintrans_scan.compile_transform_scan(
               enc, {d: rng.uniform(-0.3, 0.3, ctx.slots) for d in diags},
               ctx.max_level, ctx.slots) for _ in range(2)]
    lintrans_scan.build_key_pack(ev, set(trs[0].babies) | set(
        a for a in trs[0].giants if a))
    x = torch.stack([torch.stack([
        ctx.to_device(keys.encrypt_rns(enc.encode(
            rng.uniform(-1, 1, ctx.slots))[0])) for _ in range(2)])
        for _ in range(2)])
    got = encrypted_dp_mp_step(ev, trs, Mesh(np.arange(4).reshape(2, 2),
                                             ("dp", "mp")))(x)
    lvl, scale = ctx.max_level, ctx.default_scale
    qp = dev_level(ctx, lvl).q.p[:, None]
    want = []
    for b in range(2):
        acc = None
        for c, tr in enumerate(trs):
            ct = Ciphertext(x[b, c], lvl, scale)
            rots = lintrans_scan.baby_rotation_cache(
                ev, ct, set(tr.babies) | {0})
            part = lintrans_scan.eval_transform_scan(ev, tr, ct, rots).data
            acc = part if acc is None else add_mod(acc, part, qp)
        ct = ev.rescale(Ciphertext(acc, lvl, scale * ctx.q_primes[lvl]))
        want.append(ev.mul_relin(ct, ct).data)
    same = torch.equal(got, torch.stack(want))
    print(f"  dp x mp step rank {dist.get_rank()}: output "
          f"{tuple(got.shape)} equal to the step on one rank: {same}",
          flush=True)
    if not same:
        fail("the dp x mp step differs from the step on one rank")
    return {"shape": list(got.shape), "equal": same}


def parallel_rank(tag, rank, world, port, backend, out_dir, go):
    """One rank of a phase-12 world (a spawned process): imports, waits for
    its world's turn (`go`), joins the world on cuda:0 (or, with backend
    None, on init_multihost's defaults), loads the kernel libraries phase
    1 built, runs the world's cases and writes its record to
    out_dir/<tag>_rank<rank>.json."""
    import torch.distributed as dist

    from orion_tpu_torch.kernels import _build
    from orion_tpu_torch.parallel.multihost import init_multihost

    if not go.wait(PARALLEL_TIMEOUT_S * len(PARALLEL_WORLDS)):
        sys.exit(f"phase 12 world {tag} rank {rank}: its turn never came")
    t0 = time.perf_counter()
    kw = {} if backend is None else {"backend": backend, "device": "cuda:0"}
    dev = init_multihost(("127.0.0.1", port), world, rank,
                         timeout_s=PARALLEL_TIMEOUT_S, **kw)
    for src in _build.SOURCES:
        _build.load(src)
    cfgs = {t: yaml.safe_load(open(CONFIGS[t])) for t in ("mlp", "resnet")}
    stats = {}
    rec = {"rank": rank, "device": str(dev), "backend": dist.get_backend(),
           "up_s": time.perf_counter() - t0}
    mlp_levels = [lv for lv in range(6) if (lv + 3) % world == 0]
    if tag == "ks2":
        rec["cases"] = (
            _sharded_cases(cfgs["mlp"], "mlp", mlp_levels, stats,
                           entries=True, timed=(5,))
            + _sharded_cases(cfgs["resnet"], "resnet", (1, 7, 17, 43),
                             stats, entries=True, timed=(43,)))
    elif tag == "ks4":
        from orion_tpu_torch.parallel.mesh import dryrun_boot_mesh

        rec["cases"] = _sharded_cases(cfgs["mlp"], "mlp", mlp_levels, stats)
        rec["mlp"] = _rank_mlp(cfgs["mlp"], stats)
        rec["dp_mp"] = _rank_dp_mp()
        cap = EntryCapture()
        with cap:
            rec["boot"] = dryrun_boot_mesh(device="cuda")
        rec["boot"]["entry_cases"] = cap.replay("boot", stats, 2)
        _check_entry_forms(rank, rec["mlp"]["entry_cases"],
                           rec["boot"]["entry_cases"])
    elif tag == "ks8":
        rec["cases"] = _sharded_cases(cfgs["mlp"], "mlp", mlp_levels, stats)
    else:
        rec["cases"] = _sharded_cases(cfgs["mlp"], "mlp", (5,), stats)
        from orion_tpu_torch.parallel.mesh import dryrun_model_mesh
        rec["model"] = dryrun_model_mesh(device="cuda")
    rec["stats"] = stats
    rec["wall_s"] = time.perf_counter() - t0
    dist.destroy_process_group()
    with open(Path(out_dir) / f"{tag}_rank{rank}.json", "w") as f:
        json.dump(rec, f)


def spawn_worlds():
    """The processes of phase 12's worlds (`PARALLEL_WORLDS`), spawned
    before phases 9, 10 and 7 so that they import while those run; each
    waits for its world's turn (`check_parallel`) before it touches the
    card.  Returns [(tag, ranks, turn event, processes)]."""
    import multiprocessing

    out_dir = ROOT / "build" / "orion_tpu_torch" / "parallel"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.glob("*_rank*.json"):
        f.unlink()
    mpc = multiprocessing.get_context("spawn")
    worlds = []
    for tag, world, backend in PARALLEL_WORLDS:
        go, port = mpc.Event(), _free_port()
        procs = [mpc.Process(target=parallel_rank, daemon=True,
                             args=(tag, r, world, port, backend,
                                   str(out_dir), go))
                 for r in range(world)]
        for p in procs:
            p.start()
        worlds.append((tag, world, go, procs))
    return worlds


def check_parallel(worlds):
    """Phase 12: the parallel layer on torch.distributed, the worlds of
    processes that `spawn_worlds` started, run on the card in turn, each
    joined with a timeout, stragglers killed; any non-zero exit or
    mismatch fails.
      ks2: the sharded key-switch at M = 2 at every level of
           configs/mlp.yml where 2 | n_t and at levels 1, 7, 17, 43 of
           configs/resnet.yml, each rank's new C entries against their
           plain versions, device times against the unsharded key-switch
           at mlp level 5 and resnet level 43, and the collectives' bytes;
      ks4: M = 4 on configs/mlp.yml; the full-width MLP through
           make_sharded_forward at (dp = 2, limb = 2); the dp x mp step;
           dryrun_boot_mesh at limb = 2; the calls of both sharded
           forwards to the sharded entries against their plain versions;
      ks8: M = 8 on configs/mlp.yml (level 5, 8 extended rows);
      nccl1: one rank on init_multihost's defaults (NCCL, the rank's
           card): M = 1 at mlp level 5 and dryrun_model_mesh.
    A world touches the card only in its turn.  Returns ({tag: {"ranks":
    [rank records], ...}}, the merged case records)."""
    print("phase 12: the parallel layer, worlds of processes on cuda:0",
          flush=True)
    try:
        return _run_worlds(worlds,
                           ROOT / "build" / "orion_tpu_torch" / "parallel")
    finally:
        for *_, procs in worlds:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()


def _run_worlds(worlds, out_dir):
    """Give each world of check_parallel its turn, in order."""
    recs, stats = {}, {}
    for tag, world, go, procs in worlds:
        t0 = time.perf_counter()
        go.set()
        deadline = time.monotonic() + PARALLEL_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        stuck = [r for r, p in enumerate(procs) if p.is_alive()]
        codes = [p.exitcode for p in procs]
        if stuck:
            fail(f"phase 12 world {tag}: ranks {stuck} still running after "
                 f"{PARALLEL_TIMEOUT_S} s")
        if any(codes):
            fail(f"phase 12 world {tag}: exit codes {codes}")
        ranks = [json.loads((out_dir / f"{tag}_rank{r}.json").read_text())
                 for r in range(world)]
        for r in ranks:
            for k, v in r.pop("stats").items():
                stats.setdefault(k, []).extend(v)
        recs[tag] = {"world": world, "backend": ranks[0]["backend"],
                     "wall_s": time.perf_counter() - t0, "ranks": ranks}
        print(f"phase 12 world {tag}: {world} rank(s), backend "
              f"{ranks[0]['backend']}, {recs[tag]['wall_s']:.1f} s",
              flush=True)
    return recs, stats


def sharded_kernel_line(k, recs, parallel):
    """The kernels-line entry of a sharded C entry: its case at resnet.yml
    level 43 on rank 0 of the 2-rank world (25 of 50 rows; mlp.yml level 5
    beside it), its launches in the sharded MLP forward of phase 12 by
    rank (the main path of the slice)."""
    def pick(cfg, level):
        r = next(r for r in recs if r["config"] == cfg
                 and r["level"] == level)
        return {"shape": r["label"], "ms": r["ms"],
                "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}

    by_rank = [r["mlp"]["launches"].get(k.name, 0)
               for r in parallel["ks4"]["ranks"]]
    top = pick("resnet/r0", 43)
    return {"name": k.name, "route": "cuda",
            "source": f"orion_tpu_torch/kernels/csrc/{k.source}",
            "replaces": k.replaces, "launches": sum(by_rank),
            "launches_by_path": {"mlp_sharded_dp2_limb2": by_rank},
            "max_abs_err": max(r["err"] for r in recs),
            "bit_exact": all(r["ok"] for r in recs), "cases": len(recs),
            **top, "library_ms": None, "mlp_top": pick("mlp/r0", 5)}


def print_ptxas(libs):
    """Registers and spills of each kernel at LogN 13 and 14 (and of each
    kernel not templated on LogN), from ptxas' report beside each library
    (`, CI`: the ConjugateInvariant form).  Returns {kernel: bytes
    spilled}."""
    import re

    spilled = {}
    for src, so in libs.items():
        log = so.with_suffix(".log").read_text()
        name = None
        for line in log.splitlines():
            m = re.search(r"entry function '_Z(?:N\d+orion)?(\d+)", line)
            if m:
                base = line[m.end():m.end() + int(m.group(1))]
                t = re.match(r"ILi(\d+)E(Lb([01])E)?",
                             line[m.end() + int(m.group(1)):])
                ci = ", CI" if t and t.group(3) == "1" else ""
                name = (base if t is None else f"{base}<{t.group(1)}{ci}>"
                        if t.group(1) in ("13", "14") else None)
            elif name and "spill" in line:
                spill = re.search(r"(\d+) bytes spill stores", line).group(1)
            elif name and "Used" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                print(f"phase 1: {src} {name}: {regs} registers, {spill} "
                      f"bytes spilled", flush=True)
                spilled[name] = spilled.get(name, 0) + int(spill)
                name = None
    return spilled


# the kernels of the standard key-switch's hoisted conversion
HOISTED = ("ntt_inv_zq", "hoist_digits", "fbc_ntt_digits", "ks_inner_intt",
           "moddown_rows")
# rescale_poly's two kernels
RESCALE = ("drop_intt_rows", "rescale_lift_ntt")


def keyswitch_launches(cfg):
    """Phase 1: the device kernels of one key-switch (ks_decompose, then
    ks_finish with ModDown) at the config's top level, from a profile;
    the run fails unless they are the three grids of each kernel."""
    from orion_tpu_torch.crypto import KeyChest
    from orion_tpu_torch.crypto.keyswitch import dev_level
    from orion_tpu_torch.kernels import keyswitch as kks

    ctx = make_context(cfg)
    dl = dev_level(ctx, ctx.max_level)
    rk = KeyChest(ctx).relin_key
    c = torch.randint(0, 1 << 62, (dl.level + 1, ctx.n),
                      device="cuda") % dl.q.p[:, None]
    names = device_kernels(lambda: kks.ks_finish(kks.ks_decompose(c, dl),
                                                 dl, rk.data, rk.shoup))
    ours = [n.split("(")[0].removeprefix("void ").split("<")[0]
            .split("::")[-1] for n in names
            if any(o in n for o in OUR_KERNELS)]
    print(f"phase 1: launches per key-switch ({cfg_name('mlp')} level "
          f"{dl.level}): {len(ours)} device kernels, {', '.join(ours)} "
          f"(4 before the hoisted conversion: no hoist_digits; the "
          f"limb-sharded ks_convert_rows and ks_moddown_rows run "
          f"hoist_digits before their grid)", flush=True)
    want = ["ntt_inv_zq", "hoist_digits", "fbc_ntt_digits", "ks_inner_intt",
            "hoist_digits", "moddown_rows"]
    if ours != want:
        fail(f"one key-switch ran {ours}, not {want}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from orion_tpu_torch import kernels
    from orion_tpu_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"phase 1: device {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(_build.SOURCES)})", flush=True)
    spilled = print_ptxas(libs)
    spills = {k: v for k, v in spilled.items()
              if v and k.split("<")[0] in HOISTED + RESCALE}
    if spills:
        fail(f"the hoisted key-switch kernels or rescale_poly's spill "
             f"registers: {spills}")
    from orion_tpu_torch.kernels import ntt as kntt

    ctas = {logn: kntt.cluster_size(logn) for logn in range(8, 15)}
    print(f"phase 1: ntt_fwd / ntt_inv and the rescale epilogues launch "
          f"clusters of C CTAs per row, by LogN: {ctas}", flush=True)
    if any(c != 1 << kntt.split_logc(logn) for logn, c in ctas.items()):
        fail(f"the built ntt.cu splits rows as {ctas}, kernels/ntt.py packs "
             f"twiddles for {[1 << kntt.split_logc(g) for g in ctas]}")
    for name in ("ks_decompose_ci", "ks_finish_ci"):
        print(f"phase 1: {name} launches clusters of C CTAs per row, by "
              f"the lift's LogN (cluster_ntt.cuh's Split, as above): "
              f"{ctas}", flush=True)
    print(f"phase 1: ks_decompose's first grid (ntt_inv_zq) launches "
          f"clusters of C CTAs per Q row, by LogN: {ctas}", flush=True)
    if min(ctas[13], ctas[14]) < 2:
        fail("the transforms at LogN 13 and 14, and the CI key-switch "
             "kernels at a 2^13 or 2^14 lift, are not split over a cluster")
    with open(CONFIGS["mlp"]) as f:
        keyswitch_launches(yaml.safe_load(f))

    cfgs = {}
    for tag, path in CONFIGS.items():
        with open(path) as f:
            cfgs[tag] = yaml.safe_load(f)
    stats = {}
    check_kernels(cfgs["mlp"], "mlp", stats)
    check_kernels(cfgs["lenet"], "lenet", stats)
    print(f"phase 2 lenet done at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    # the ConjugateInvariant ring: the kernels' CI forms at every level of
    # configs/lola.yml (transforms of 2^14) and tests/configs/mlp.yml (2^13)
    check_kernels(cfgs["lola"], "lola", stats)
    check_kernels(cfgs["mlp_ci"], "mlp_ci", stats)
    print(f"phase 2b done at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    # every level that rescales: timed in full at four levels; at the
    # others a few calls and the plain version once (for the comparison).
    # Every kernel runs at the untimed levels that, with the timed ones,
    # hold each digit count and each size of the last digit (alpha 6):
    # each sixth level (2 to 7 digits, the last of one row), levels 2-5
    # (one digit of 3 to 6 rows) and 8-10 (two, the last of 3 to 5 rows);
    # the rescale epilogues alone at the others
    timed = (1, 17, 42, 43)
    check_kernels(cfgs["resnet"], "resnet", stats, levels=timed, iters=10,
                  plain_iters=1)
    full = sorted({2, 3, 4, 5, 8, 9, 10} | set(range(6, 42, 6)))
    check_kernels(cfgs["resnet"], "resnet", stats, levels=full, iters=3,
                  plain_iters=0)
    check_kernels(cfgs["resnet"], "resnet", stats,
                  levels=[lv for lv in range(1, 44)
                          if lv not in timed and lv not in full],
                  iters=3, plain_iters=0, epilogues_only=True)
    for tag, level in (("lenet", 7), ("resnet", 43), ("lola", 5)):
        stress_rescale(cfgs[tag], tag, level)
    torch.cuda.empty_cache()
    print(f"phase 2 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    # AlexNet and VGG-11 fit and compile in processes of their own while
    # phases 3-6 run (phase 7, which times kernels, runs after their turns)
    nets = spawn_nets(cfgs)

    paths = {
        "mlp": check_model(cfgs["mlp"], "MLP",
                           "phase 3: MLP 784-128-128-10 on configs/mlp.yml",
                           stream=True),
        "lenet": check_model(cfgs["lenet"], "LeNet",
                             "phase 4: LeNet on configs/lenet.yml",
                             stream=True),
    }
    print(f"phase 4 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    for tag, model, title in (
            ("lola_ci", "LoLA", "phase 4b: LoLA on configs/lola.yml "
             "(ConjugateInvariant, LogN 13)"),
            ("mlp_ci", "MLP", "phase 4c: MLP 784-128-128-10 on "
             "tests/configs/mlp.yml (ConjugateInvariant, LogN 12)"),
            ("lola14", "LoLA", "phase 4d: LoLA on configs/lola2.yml "
             "(standard, LogN 14)")):
        cfg = cfgs[{"lola_ci": "lola", "lola14": "lola2"}.get(tag, tag)]
        # the finished paths' schemes go before this one reads memory
        gc.collect()
        paths[tag] = check_model(cfg, model, title)
    print(f"phase 4d done at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    # a scheme's services and modules refer to each other: collect the
    # finished phases' schemes before the next phase reads device memory
    gc.collect()
    bootstrap, cpu_boot = check_bootstrap(cfgs["resnet"])
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 5 on the card done at {time.perf_counter() - t_start:.1f}"
          f" s", flush=True)
    paths["resnet"] = check_resnet(cfgs["resnet"], batch=2, extra=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"resnet phase done at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    join_cpu_bootstrap(bootstrap, cpu_boot)
    for tag, proc, events, path in nets:
        paths[tag] = join_net(tag, proc, events, path)
        print(f"{tag} phase done at {time.perf_counter() - t_start:.1f} s",
              flush=True)
    # phase 8 on ResNet-20 ran inside its phase 6 (the compiled net reused)
    paths["resnet_b2"] = paths["resnet"].pop("batched")
    extra = {"resnet_noise_resident": paths["resnet"].pop("extra")}

    # phase 8: batched serving; 8b: key and diagonal I/O
    paths.update(check_serving(
        cfgs["mlp"], "MLP", "serve_mlp", (1, 2, 4, 8),
        "phase 8: MLP 784-128-128-10 on configs/mlp.yml served in batches "
        "of B = 1, 2, 4, 8"))
    gc.collect()
    paths.update(check_serving(
        cfgs["lola"], "LoLA", "serve_lola_ci", (8,),
        "phase 8: LoLA on configs/lola.yml (ConjugateInvariant) served in "
        "a batch of B = 8"))
    gc.collect()
    io_recs = {tag: check_io(cfgs[tag], model, tag,
                             paths[tag]["compile_s"],
                             f"phase 8b: {model} on configs/{tag}.yml with "
                             f"io_mode save, then load")
               for tag, model in (("mlp", "MLP"), ("lenet", "LeNet"))}
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 8 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    # phase 12's processes import while phases 9, 10 and 7 run
    worlds = spawn_worlds()
    # phase 9: training, 9b: noise profiles, 10: the naive BSGS oracle
    extra["training"] = check_training(cfgs["lenet"])
    extra["tiny_vgg_noise"] = check_tiny_vgg_noise()
    gc.collect()
    extra["oracle"] = check_oracle(cfgs["mlp"])
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phases 9-10 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    for tag, path in (("mlp", "mlp"), ("lenet", "lenet"), ("lola", "lola_ci"),
                      ("mlp_ci", "mlp_ci"), ("lola2", "lola14")):
        check_batched(make_context(cfgs[tag]), tag, stats,
                      paths[path]["batches"])
        print(f"phase 7 {tag} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)
    ctx, done = make_context(cfgs["resnet"]), set()
    for tag in BOOTSTRAPPED:
        b = paths[tag]["batches"]
        check_batched(ctx, tag, stats, b, lean=True, done=done,
                      levels=batched_levels(b))
        print(f"phase 7 {tag} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)
    # phase 8's batched forwards: the batches of ResNet-20 at B = 2, of
    # the MLP at B = 8 and of LoLA-CI at B = 8 (the CI kernels, items
    # grouped by query), at the level of each one's largest ks_finish
    # launch
    for tag, ctx_b, rec, lean, q in (
            ("resnet_b2", ctx, paths["resnet_b2"], True, 2),
            ("mlp_b8", make_context(cfgs["mlp"]), paths["serve_mlp_b8"],
             False, 8),
            ("lola_b8", make_context(cfgs["lola"]),
             paths["serve_lola_ci_b8"], False, 8)):
        fin = rec["batches"][kernel_names(ctx_b)["ks_finish"]]
        top = max(fin, key=lambda lv: max(fin[lv]))
        check_batched(ctx_b, tag, stats, rec["batches"], levels=[top],
                      lean=lean, queries=q)
        print(f"phase 7 {tag} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)
    del ctx, ctx_b
    # LogN 14: one key-switch per call, then a batch of 4, at the top level
    ctx14 = check_kernels(cfgs["mlp"], "mlp14", stats, logn=14, levels=[5])
    check_batched(ctx14, "mlp14", stats, {}, levels=[5])
    del ctx14
    print(f"phase 7 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)
    # phase 12: the parallel layer, in worlds of processes on the card
    gc.collect()
    torch.cuda.empty_cache()
    parallel, pstats = check_parallel(worlds)
    for k, v in pstats.items():
        stats.setdefault(k, []).extend(v)
    print(f"phase 12 done at {time.perf_counter() - t_start:.1f} s",
          flush=True)

    line = []
    for k in kernels.KERNELS:
        recs = stats[k.name]
        if k in kernels.SHARDED:
            line.append(sharded_kernel_line(k, recs, parallel))
            continue
        ci = k.name.endswith("_ci")
        # the first case at the top level of this slice's config: the 2-D
        # transforms, full-chain Shoup keys for ks_finish, one ciphertext
        # for the rescale epilogues (configs/lola.yml's for the CI forms)
        home, home_level = ("lola", 5) if ci else ("lenet", 7)
        top = next(r for r in recs if r["config"] == home
                   and r["level"] == home_level)
        by_path = {p: rec["launches"][k.name] for p, rec in paths.items()}
        by_path["mlp_sharded_dp2_limb2"] = sum(
            r["mlp"]["launches"].get(k.name, 0)
            for r in parallel["ks4"]["ranks"])
        line.append({
            "name": k.name, "route": "cuda",
            "source": f"orion_tpu_torch/kernels/csrc/{k.source}",
            "replaces": k.replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["err"] for r in recs),
            "bit_exact": all(r["ok"] for r in recs),
            "cases": len(recs),
            "shape": top["label"],
            "ms": top["ms"], "device_ms": top["device_ms"],
            "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None,
        })
        if k.source == "ntt.cu" or ci:
            line[-1]["cluster_ctas"] = ctas[14 if ci else 13]
        # the top level of configs/resnet.yml (44 Q rows, 50 extended
        # rows, 8 digits), lean trimmed keys for ks_finish; the CI forms
        # at the top level of tests/configs/mlp.yml (transforms of 2^13)
        res = [r for r in recs if r["level"] == (5 if ci else 43)
               and r["config"] == ("mlp_ci" if ci else "resnet")]
        r = next((r for r in res if "trimmed lean" in r["label"]), res[0])
        line[-1]["mlp_ci_top" if ci else "resnet_top"] = {
            "shape": r["label"], "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"]}
        pair = {"drop_ntt": "drop_pair", "rescale_ntt": "rescale_pair",
                "rescale_ntt_ci": "rescale_pair_ci"}.get(k.name)
        if pair:
            r = next(r for r in stats[pair] if r["config"] == home
                     and r["level"] == home_level)
            line[-1]["pair"] = {
                "shape": r["label"], "ms": r["ms"],
                "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "max_abs_err": max(x["err"] for x in stats[pair]),
                "bit_exact": all(x["ok"] for x in stats[pair])}
        # conv2's batch (lenet level 5): the largest launch of LeNet's
        # forward; the largest of the bootstrapped nets' forwards; the
        # largest of the CI forwards
        lenet = [r for r in recs if r["config"] == "lenet"
                 and r["level"] == 5 and r["items"] > 1]
        deep = sorted((r for r in recs if r["config"] in BOOTSTRAPPED
                       and r["items"] > 1), key=lambda r: -r["items"])
        cib = sorted((r for r in recs if ci and r["items"] > 1),
                     key=lambda r: -r["items"])
        for key, batched in (("batched", lenet),
                             ("batched_bootstrapped", deep),
                             ("batched_ci", cib)):
            if batched:
                r = batched[0]
                line[-1][key] = {
                    "shape": r["label"], "items": r["items"], "ms": r["ms"],
                    "device_ms": r["device_ms"],
                    "ms_per_item": r["ms"] / r["items"],
                    "device_ms_per_item": r["device_ms"] / r["items"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}
    for p, rec in paths.items():
        print(json.dumps({p: rec}), flush=True)
    print(json.dumps({"bootstrap": bootstrap}), flush=True)
    print(json.dumps({"io": io_recs}), flush=True)
    for k, rec in extra.items():
        print(json.dumps({k: rec}), flush=True)
    print(json.dumps({"parallel": parallel}), flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(f"chip_smoke: whole run {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def forward_copies(tree):
    """`python3 chip_smoke.py --forward-copies DIR`: phase 6's ResNet-20
    alone, with the orion_tpu_torch package of DIR (an unpacked copy of
    another commit, `git archive <commit> | tar -x -C DIR`) and its
    kernels built from DIR.  Prints the profiled forward's host-to-device
    copies and stream synchronisations as its last line, which phase 6 of
    a whole run prints for this checkout: two commits compare in one call
    on one card."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    tree = Path(tree).resolve()
    sys.path.insert(0, str(tree))
    import orion_tpu_torch
    from orion_tpu_torch.kernels import _build

    if Path(orion_tpu_torch.__file__).resolve().parents[1] != tree:
        fail(f"orion_tpu_torch imported from {orion_tpu_torch.__file__}, "
             f"not from {tree}")
    _build.build_all()
    with open(CONFIGS["resnet"]) as f:
        rec = check_resnet(yaml.safe_load(f))
    pr = rec["profile"]
    print(json.dumps({"tree": str(tree), "model": rec["model"],
                      "h2d_copies": pr["h2d_copies"],
                      "stream_syncs": pr["stream_syncs"],
                      "device_ops": pr["device_ops"]}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--forward-copies":
        sys.exit(forward_copies(sys.argv[2]))
    if len(sys.argv) > 1:
        sys.exit(f"usage: {sys.argv[0]} [--forward-copies DIR]")
    sys.exit(main())
