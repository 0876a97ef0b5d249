"""Multi-rank execution of the encrypted evaluator on torch.distributed.

Counterpart of `orion_tpu/parallel/mesh.py`.  The parallel axes of
encrypted inference:

  * dp   - the batch of independent encrypted queries: each dp row of the
           mesh runs its share, and the outputs are all-gathered;
  * mp   - the column blocks of a blocked linear transform: each mp rank
           holds its columns' ciphertexts and encoded diagonals, computes
           its partial block-row product (rotations and key-switches stay
           rank-local), and the partials are all-gathered and folded with
           add_mod, as orion_tpu folds them (a psum of residues would leave
           the range; a fold keeps every partial sum reduced);
  * limb - the RNS rows of every key-switch (`limbshard.py`).

orion_tpu runs one SPMD program over a `jax.sharding.Mesh` and lets XLA
insert the collectives.  The port runs one process per rank, each on its
device, and calls the collectives itself: `Mesh` is the matrix of ranks
with named axes and one process group per line of each axis (every rank
builds every group, as `torch.distributed.new_group` requires).  Every
rank calls these functions with the same arguments, SPMD style.

The dry runs (`dryrun_model_mesh`, `dryrun_boot_mesh`, `dryrun_multichip`)
are what a rank of an initialised world (`multihost.init_multihost`) calls
to run the framework's parallel paths on tiny shapes.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

from ..crypto import lintrans_scan
from ..crypto.ciphertext import Ciphertext
from ..crypto.keyswitch import dev_level, set_limb_group
from ..crypto.modops import add_mod
from .limbshard import LimbGroup, all_gather


class Mesh:
    """A matrix of ranks with named axes (`ranks[i, j]`: the rank at dp
    row i, column j), and a process group per line of each axis.

    The groups take the world's backend.  `hosts` (the host index of each
    rank, as `multihost.rank_hosts` gives it) is only read by
    `multihost.mesh_report`."""

    def __init__(self, ranks, axis_names, hosts=None):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"a {self.ranks.ndim}-D rank matrix for axes "
                             f"{self.axis_names}")
        if len(set(self.ranks.flat)) != self.ranks.size:
            raise ValueError("a rank appears twice in the mesh")
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self.hosts = hosts
        me = dist.get_rank()
        where = np.argwhere(self.ranks == me)
        self.coords = (None if not len(where)
                       else dict(zip(self.axis_names, map(int, where[0]))))
        self._groups = {}
        for ax, name in enumerate(self.axis_names):
            lines = np.moveaxis(self.ranks, ax, -1).reshape(
                -1, self.ranks.shape[ax])
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                if me in line:
                    self._groups[name] = group

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        if self.coords is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
        return self.coords[axis]

    def group(self, axis: str):
        """The process group of this rank's line along `axis`."""
        self.index(axis)
        return self._groups[axis]


def build_mesh(n_devices: int) -> Mesh:
    """Factor ranks 0..n-1 into a (dp, mp) mesh: mp 4 or 2 where it
    divides n, else 1."""
    if n_devices > dist.get_world_size():
        raise ValueError(f"{n_devices} ranks asked of a world of "
                         f"{dist.get_world_size()}")
    mp = next((c for c in (4, 2) if n_devices % c == 0), 1)
    return Mesh(np.arange(n_devices).reshape(n_devices // mp, mp),
                ("dp", "mp"))


def stack_member_transforms(transforms: list):
    """Stack per-member column-block transforms for mp sharding.

    All members must share BSGS structure (same diagonal index set, n1,
    level, pt_scale), true for the column blocks of one packed matrix, so
    only the encoded diagonals differ.  Returns (template transform, pts
    stack (members, n_d, L+1, N)).  The port's transforms hold no Shoup
    companions (`lintrans_scan.compile_transform_scan`)."""
    t0 = transforms[0]
    for tr in transforms[1:]:
        if (tr.n1 != t0.n1 or tr.level != t0.level
                or tr.pt_scale != t0.pt_scale
                or tr.babies_full != t0.babies_full
                or tr.giants != t0.giants
                or tr.pts.shape != t0.pts.shape):
            raise ValueError("member transforms must share BSGS structure")
    return t0, torch.stack([tr.pts for tr in transforms])


def _fold(parts, qp):
    out = parts[0]
    for p in parts[1:]:
        out = add_mod(out, p, qp)
    return out


def encrypted_dp_mp_step(ev, transforms: list, mesh: Mesh):
    """Build a sharded encrypted forward step over a (dp, mp) mesh.

    Returns step(x): x int64 (B, C, 2, L, N) on every rank, B encrypted
    queries (dp) of C ciphertexts each (mp, one column block per
    ciphertext, `transforms[c]`).  The step: a blocked matvec (one block
    row: out = sum_c T[c] @ ct_c), rescale, then an encrypted square
    (mul_relin with its rescale).  The rank at (i, j) takes queries
    i*B/dp.. and columns j*C/mp..; the key-switches of its rotations run
    on its device through the port's kernels (`baby_rotation_cache`,
    `eval_transform_scan`); the partial products are all-gathered over mp
    and folded; the outputs (B, 2, L-2, N) are all-gathered over dp, so
    every rank returns the whole batch."""
    level = transforms[0].level
    qp = dev_level(ev.ctx, level).q.p[:, None]
    scale = ev.ctx.default_scale
    template, pts = stack_member_transforms(transforms)
    dp, mp = mesh.size("dp"), mesh.size("mp")
    if pts.shape[0] % mp:
        raise ValueError(f"{pts.shape[0]} column blocks over mp = {mp}")
    c_loc = pts.shape[0] // mp
    cols = range(mesh.index("mp") * c_loc, (mesh.index("mp") + 1) * c_loc)
    mine = {c: replace(template, pts=pts[c]) for c in cols}

    def local_block(ct_data, tr):
        ct = Ciphertext(ct_data, level, scale)
        rots = lintrans_scan.baby_rotation_cache(
            ev, ct, set(tr.babies) | {0})
        return lintrans_scan.eval_transform_scan(ev, tr, ct, rots).data

    def step(x):
        if x.shape[0] % dp or x.shape[1] != pts.shape[0]:
            raise ValueError(f"input {tuple(x.shape)} for dp = {dp} and "
                             f"{pts.shape[0]} column blocks")
        b_loc = x.shape[0] // dp
        first = mesh.index("dp") * b_loc
        outs = []
        for b in range(first, first + b_loc):
            local = _fold([local_block(x[b, c], tr)
                           for c, tr in mine.items()], qp)
            full = _fold(list(all_gather(local, mesh.group("mp"))), qp)
            ct = Ciphertext(full, level, scale * ev.ctx.q_primes[level])
            ct = ev.rescale(ct)
            ct = ev.mul_relin(ct, ct)  # encrypted square, relin + rescale
            outs.append(ct.data)
        got = all_gather(torch.stack(outs), mesh.group("dp"))
        return got.reshape((x.shape[0],) + tuple(got.shape[2:]))

    return step


# ------------------------------------------------------------------ #
#  Dry runs on tiny shapes                                           #
# ------------------------------------------------------------------ #

def _world_mesh(n_devices):
    """A (dp, limb) mesh of the whole world: limb 2 when n is even, as
    orion_tpu's dry runs take it."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a dry run over {n} ranks in a world of {world}")
    k = 2 if n % 2 == 0 else 1
    return Mesh(np.arange(n).reshape(n // k, k), ("dp", "limb"))


def tiny_mlp():
    """orion_tpu's TinyMLP (16 -> 8 -> Quad -> 4)."""
    from .. import nn as on

    class TinyMLP(on.Module):
        def __init__(self):
            super().__init__()
            self.flatten = on.Flatten()
            self.fc1 = on.Linear(16, 8)
            self.act1 = on.Quad()
            self.fc2 = on.Linear(8, 4)

        def forward(self, x):
            return self.fc2(self.act1(self.fc1(self.flatten(x))))

    return TinyMLP()


def deep_mlp():
    """orion_tpu's DeepMLP (16 -> 8 -> Quad -> 8 -> Quad -> 4): deeper
    than its chain, so the solver places a bootstrap."""
    from .. import nn as on

    class DeepMLP(on.Module):
        def __init__(self):
            super().__init__()
            self.flatten = on.Flatten()
            self.fc1 = on.Linear(16, 8)
            self.act1 = on.Quad()
            self.fc2 = on.Linear(8, 8)
            self.act2 = on.Quad()
            self.fc3 = on.Linear(8, 4)

        def forward(self, x):
            x = self.act1(self.fc1(self.flatten(x)))
            x = self.act2(self.fc2(x))
            return self.fc3(x)

    return DeepMLP()


TINY_CONFIG = dict(
    ckks_params=dict(LogN=8, LogQ=[29, 26, 26, 26], LogP=[29, 29],
                     LogScale=26, H=64),
    orion=dict(margin=2, embedding_method="hybrid", backend="tpu",
               fuse_modules=True, debug=False, io_mode="none"))
BOOT_CONFIG = dict(
    ckks_params=dict(LogN=9, LogQ=[29, 26, 26, 26], LogP=[29, 29],
                     LogScale=26, H=64),
    boot_params=dict(CtSLevels=3, StCLevels=3, ModDegree=255, K=15),
    orion=dict(margin=2, embedding_method="hybrid", backend="tpu",
               fuse_modules=True, debug=False, io_mode="stream"))


def _max_err(out, want) -> float:
    got = np.asarray(out.decrypt().decode()).reshape(-1)[: want.size]
    return float(np.max(np.abs(got - want)))


def dryrun_model_mesh(n_devices: int | None = None,
                      device="cuda") -> dict:
    """fit -> compile -> encrypt -> SHARDED forward -> decrypt.

    A compiled TinyMLP over a (dp, limb) mesh of the world through
    `runtime.mesh.make_sharded_forward`: the queries shared over dp, every
    key-switch limb-sharded.  Raises unless the decrypted error against
    the clear net is below 5e-3."""
    from ..runtime.mesh import encrypt_batch, make_sharded_forward
    from ..runtime.scheme import Scheme

    mesh = _world_mesh(n_devices)
    dp, limb = mesh.size("dp"), mesh.size("limb")
    scheme = Scheme().init_scheme(TINY_CONFIG, device=device)
    rng = np.random.default_rng(0)
    fit_data = [rng.uniform(-1, 1, (1, 1, 4, 4)).astype(np.float32)
                for _ in range(32)]
    net = tiny_mlp()
    net.eval()
    queries = [rng.uniform(-1, 1, (1, 1, 4, 4)).astype(np.float32)
               for _ in range(dp)]
    clear = [np.asarray(net(q)).reshape(-1) for q in queries]
    scheme.fit(net, fit_data, batch_size=16)
    input_level = scheme.compile(net)
    net.he()
    outs = make_sharded_forward(net, scheme, mesh)(
        encrypt_batch(scheme, queries, input_level))
    err = max(_max_err(o, w) for o, w in zip(outs, clear))
    if not np.isfinite(err) or err > 5e-3:
        raise AssertionError(f"sharded model forward mismatch: err={err}")
    print(f"[dryrun_multichip] model forward on (dp={dp}, limb={limb}) "
          f"mesh OK, max err={err:.2e}", flush=True)
    return {"dp": dp, "limb": limb, "err": err}


def dryrun_boot_mesh(n_devices: int | None = None, device="cuda") -> dict:
    """fit -> compile -> encrypt -> limb-SHARDED forward of a BOOTSTRAPPED
    net (DeepMLP at LogN 9, `io_mode: stream`).

    The chain is shorter than the net, so the solver places a bootstrap;
    the forward then runs every key-switch of the net and of the
    bootstrap (CtS, EvalMod, StC) sharded over the rank's limb group.
    Raises unless the sharded output equals the unsharded forward's bit
    for bit and decrypts within 5e-3 of the clear net."""
    from ..runtime.scheme import Scheme

    mesh = _world_mesh(n_devices)
    dp, limb = mesh.size("dp"), mesh.size("limb")
    scheme = Scheme().init_scheme(BOOT_CONFIG, device=device)
    rng = np.random.default_rng(5)
    fit_data = [rng.uniform(-1, 1, (1, 1, 4, 4)).astype(np.float32)
                for _ in range(16)]
    net = deep_mlp()
    net.eval()
    query = rng.uniform(-1, 1, (1, 1, 4, 4)).astype(np.float32)
    want = np.asarray(net(query)).reshape(-1)
    scheme.fit(net, fit_data, batch_size=8)
    input_level = scheme.compile(net)
    placed = [m for m in net.modules()
              if getattr(m, "post_bootstrap", None) is not None]
    if not placed:
        raise AssertionError("level solver placed no bootstrap")
    net.he()
    ct = scheme.encrypt(scheme.encode(query, input_level))
    alone = net(ct)
    prev = set_limb_group(LimbGroup(mesh.group("limb")) if limb > 1
                          else None)
    try:
        out = net(ct)
    finally:
        set_limb_group(prev)
    equal = all(torch.equal(a.data, b.data)
                for a, b in zip(out.cts, alone.cts))
    if not equal:
        raise AssertionError("sharded bootstrapped forward differs from "
                             "the unsharded one")
    err = _max_err(out, want)
    if not np.isfinite(err) or err > 5e-3:
        raise AssertionError(f"sharded bootstrapped forward mismatch: "
                             f"err={err}")
    print(f"[dryrun_multichip] bootstrapped forward ({len(placed)} "
          f"bootstrap(s)) on (dp={dp}, limb={limb}) mesh OK, equal to the "
          f"unsharded forward, max err={err:.2e}", flush=True)
    return {"dp": dp, "limb": limb, "bootstraps": len(placed), "err": err,
            "equal": equal}


def dryrun_multichip(n_devices: int | None = None, device="cuda") -> dict:
    """Run the sharded encrypted paths on tiny shapes, in every rank of an
    initialised world:
      1. a compiled network dp x limb sharded (`dryrun_model_mesh`);
      2. a compiled network with a bootstrap, limb-sharded
         (`dryrun_boot_mesh`);
      3. the limb-sharded key-switch (`limbshard.py`) over the world:
         key row blocks per rank, the digit all-gather and the ModDown
         all-reduce, bit-exact against the unsharded `keyswitch`.
    orion_tpu's third case runs at LogN 6; the kernels start at LogN 8,
    so the port's runs at LogN 8 with the same chain (8 extended rows)."""
    from ..crypto import CKKSContext, KeyChest
    from ..crypto.keyswitch import keyswitch
    from .limbshard import make_sharded_keyswitch

    rec = {"model": dryrun_model_mesh(n_devices, device),
           "boot": dryrun_boot_mesh(n_devices, device)}
    m = dist.get_world_size()
    ctx = CKKSContext(logn=8, logq=[28, 26, 26, 26, 26, 26], logp=[28, 28],
                      logscale=26, h=16, seed=7, device=device)
    if 8 % m == 0 and m > 1:
        keys = KeyChest(ctx)
        lvl = ctx.max_level
        rng = np.random.default_rng(7)
        c = ctx.to_device(np.stack([
            rng.integers(0, ctx.primes[i], ctx.n, dtype=np.int64)
            for i in range(lvl + 1)]))
        rk = keys.relin_key
        want = keyswitch(c, dev_level(ctx, lvl), rk.data, rk.shoup)
        sks = make_sharded_keyswitch(ctx, lvl)
        kd, kss = sks.shard_ksk(rk.data, rk.shoup, ctx)
        got = sks.gather(sks.fn(sks.put(sks.pad_poly(c)), sks.put(kd),
                                sks.put(kss)))[:, : lvl + 1]
        if not torch.equal(got, want):
            raise AssertionError("limb-sharded keyswitch mismatch")
        print(f"[dryrun_multichip] limb-sharded keyswitch OK (M={m}, "
              f"bit-exact)", flush=True)
        rec["keyswitch"] = {"m": m, "equal": True}
    return rec
