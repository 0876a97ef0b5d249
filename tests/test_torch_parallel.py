"""The parallel layer (`orion_tpu_torch/parallel/`, `runtime/mesh.py`)
against orion_tpu's, on the CPU.

One world of 4 gloo ranks on the CPU serves every case of this file: four
worker processes that import no jax (`WORKER`), started once per module.
The parent process runs orion_tpu on the conftest's 8 virtual CPU devices,
jitted as orion_tpu's own parallel tests run it, while the workers run,
and the two sides meet through `.npz` files in a temporary directory.

* Key-switch: the port's limb-sharded key-switch at M = 2 (two groups of
  2 ranks) and M = 4 equals orion_tpu's `make_sharded_keyswitch` on M
  devices and the unsharded `keyswitch`, at the top level (8 extended
  rows) and at level 1 (4 rows), through `ShardedKS.fn` (row blocks of the
  key) and through the forward's seam (`set_limb_group`, replicated keys).
  orion_tpu's test context at LogN 8 instead of 6: the port's transforms
  start at 2^8.
* Mesh: `make_dcn_mesh(limb=2)` over 2 hosts of 2 ranks (LOCAL_WORLD_SIZE)
  lays dp across hosts and limb within one; limb=3 and uneven hosts
  raise.
* dp x mp: `encrypted_dp_mp_step` at dp = 2, mp = 2 on
  `__graft_entry__.entry()`'s shapes (LogN 8, two member transforms over
  one diagonal index set) equals orion_tpu's step.
* Sharded forward: `make_sharded_forward` of tests/parallel's TinyMLP on
  its config at (dp = 2, limb = 2), orion_tpu's weights carried across,
  equals orion_tpu's `make_sharded_forward` on a (2, 2) mesh, error
  < 5e-3.
* Bootstrap: `dryrun_boot_mesh`'s DeepMLP (LogN 9, one bootstrap placed,
  io_mode stream) at limb = 2 equals the port's unsharded forward bit for
  bit.
"""

import json
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from .parallel.test_mesh_forward import TinyMLP
from .test_torch_mlp import shared

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
KS_CTX = dict(logn=8, logq=[28, 26, 26, 26, 26, 26], logp=[28, 28],
              logscale=26, h=16, seed=11)
KS_LEVELS = (5, 1)
TINY_CONFIG = dict(
    ckks_params=dict(LogN=8, LogQ=[29, 26, 26, 26], LogP=[29, 29],
                     LogScale=26, H=64),
    orion=dict(margin=2, embedding_method="hybrid", backend="tpu",
               fuse_modules=True, debug=False, io_mode="none"))
DIAGS = (0, 1, 2, 5, 17, 40)

WORKER = r"""
import json, os, sys
import numpy as np
import torch

rank, world, port, tmp = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
sys.path.insert(0, os.environ["ORION_REPO"])
torch.set_num_threads(1)
import torch.distributed as dist
from orion_tpu_torch.parallel.multihost import (init_multihost,
                                                make_dcn_mesh, mesh_report)

init_multihost(("127.0.0.1", port), world, rank, backend="gloo")
inp = dict(np.load(os.path.join(tmp, "inputs.npz")))
cfg = json.loads(open(os.path.join(tmp, "inputs.json")).read())
out, rec = {}, {}

# ---- mesh layout
mesh = make_dcn_mesh(limb=2)
rec["report"] = mesh_report(mesh)
rec["ranks"] = mesh.ranks.tolist()
for tag, kw in (("limb3", dict(limb=3)),
                ("uneven", dict(limb=1, hosts=[0, 0, 0, 1]))):
    try:
        make_dcn_mesh(**kw)
        rec[tag] = "no error"
    except ValueError as e:
        rec[tag] = str(e)

# ---- limb-sharded key-switch, M = 2 (two groups) and M = 4
from orion_tpu_torch.crypto import CKKSContext, KeyChest
from orion_tpu_torch.crypto.keyswitch import dev_level, keyswitch, set_limb_group
from orion_tpu_torch.parallel.limbshard import LimbGroup, make_sharded_keyswitch

ctx = CKKSContext(**cfg["ks_ctx"], device="cpu")
rk = KeyChest(ctx).relin_key
pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
for m, group in ((2, pairs[rank // 2]), (4, None)):
    for lvl in cfg["ks_levels"]:
        c = torch.as_tensor(inp[f"ks_c{lvl}"])
        sks = make_sharded_keyswitch(ctx, lvl, group)
        kd, kss = sks.shard_ksk(rk.data, rk.shoup, ctx)
        got = sks.gather(sks.fn(sks.put(sks.pad_poly(c)), sks.put(kd),
                                sks.put(kss)))
        out[f"ks_fn_m{m}_l{lvl}"] = got.numpy()
        prev = set_limb_group(LimbGroup(group))
        try:
            seam = keyswitch(c, dev_level(ctx, lvl), rk.data, rk.shoup)
        finally:
            set_limb_group(prev)
        out[f"ks_seam_m{m}_l{lvl}"] = seam.numpy()

# ---- dp x mp step at dp = 2, mp = 2
from orion_tpu_torch.crypto import Encoder, Evaluator
from orion_tpu_torch.crypto import lintrans_scan
from orion_tpu_torch.parallel.mesh import Mesh, encrypted_dp_mp_step

gctx = CKKSContext(logn=8, logq=[29, 26, 26, 26], logp=[29, 29],
                   logscale=26, h=64, seed=3, device="cpu")
enc, keys = Encoder(gctx), KeyChest(gctx)
ev = Evaluator(gctx, keys)
trs = [lintrans_scan.compile_transform_scan(
           enc, {d: v for d, v in zip(cfg["diags"], member)},
           gctx.max_level, gctx.slots)
       for member in inp["diags"]]
lintrans_scan.build_key_pack(ev, set(trs[0].babies) | set(
    a for a in trs[0].giants if a))
step = encrypted_dp_mp_step(ev, trs, Mesh(np.arange(4).reshape(2, 2),
                                          ("dp", "mp")))
out["dpmp"] = step(torch.as_tensor(inp["dpmp_x"])).numpy()

# ---- sharded forward of TinyMLP at (dp = 2, limb = 2)
from orion_tpu_torch.models import load_jax_params
from orion_tpu_torch.parallel.mesh import tiny_mlp
from orion_tpu_torch.runtime.mesh import encrypt_batch, make_sharded_forward
from orion_tpu_torch.runtime.scheme import Scheme

scheme = Scheme().init_scheme(cfg["tiny_config"], device="cpu")
net = tiny_mlp()
load_jax_params(net, {k[4:]: v for k, v in inp.items()
                      if k.startswith("mlp.")})
net.eval()
scheme.fit(net, list(inp["fit"]), batch_size=16)
level = scheme.compile(net)
net.he()
outs = make_sharded_forward(net, scheme, mesh)(
    encrypt_batch(scheme, list(inp["queries"]), level))
for b, o in enumerate(outs):
    for i, ct in enumerate(o.cts):
        out[f"fwd_q{b}_ct{i}"] = ct.data.numpy()
    rec[f"fwd_q{b}_meta"] = [[ct.level, ct.scale] for ct in o.cts]
    rec[f"fwd_q{b}_dec"] = np.asarray(o.decrypt().decode()).reshape(
        -1).tolist()

# ---- the bootstrapped DeepMLP at limb = 2
from orion_tpu_torch.parallel.mesh import dryrun_boot_mesh

rec["boot"] = dryrun_boot_mesh(device="cpu")
rec["jax_imported"] = any(m.split(".")[0] in ("jax", "jaxlib", "orion_tpu")
                          for m in sys.modules)
np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
    json.dump(rec, f)
dist.destroy_process_group()
print(f"worker {rank}: OK", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _params(net):
    """An orion_tpu net's weights, as load_jax_params takes them."""
    out = {}
    for name, m in net.named_modules():
        for attr in ("weight", "bias"):
            p = getattr(m, attr, None)
            if p is not None and hasattr(p, "data"):
                out[f"{name}.{attr}"] = np.asarray(p.data, np.float32)
    return out


def _inputs(tmp):
    """Everything both sides start from, written for the workers."""
    from orion_tpu.crypto import CKKSContext, Encoder, Evaluator, KeyChest
    from orion_tpu.crypto import lintrans_scan

    inp = {}
    ctx = CKKSContext(**KS_CTX)
    rng = np.random.default_rng(3)
    for lvl in KS_LEVELS:
        inp[f"ks_c{lvl}"] = np.stack([
            rng.integers(0, ctx.primes[i], ctx.n, dtype=np.int64)
            for i in range(lvl + 1)])
    # entry()'s context and diagonal set, two member transforms
    gctx = CKKSContext(logn=8, logq=[29, 26, 26, 26], logp=[29, 29],
                       logscale=26, h=64, seed=3)
    enc, keys = Encoder(gctx), KeyChest(gctx)
    ev = Evaluator(gctx, keys)
    rng = np.random.default_rng(0)
    inp["diags"] = rng.uniform(-0.3, 0.3, (2, len(DIAGS), gctx.slots))
    trs = [lintrans_scan.compile_transform_scan(
               enc, dict(zip(DIAGS, member)), gctx.max_level, gctx.slots)
           for member in inp["diags"]]
    lintrans_scan.build_key_pack(ev, set(trs[0].babies) | set(
        a for a in trs[0].giants if a))
    x = []
    for _ in range(2):                       # queries (dp)
        row = []
        for _ in range(2):                   # column blocks (mp)
            pt, _s = enc.encode(rng.uniform(-1, 1, gctx.slots))
            row.append(keys.encrypt_rns(pt).astype(np.uint32))
        x.append(row)
    inp["dpmp_x"] = np.asarray(x).astype(np.int64)
    # tests/parallel/test_mesh_forward.py's TinyMLP and data
    jnet = TinyMLP()
    for k, v in _params(jnet).items():
        inp[f"mlp.{k}"] = v
    rng = np.random.default_rng(1)
    inp["fit"] = np.stack([rng.uniform(-1, 1, (1, 1, 4, 4))
                           for _ in range(32)]).astype(np.float32)
    inp["queries"] = np.stack([rng.uniform(-1, 1, (1, 1, 4, 4))
                               for _ in range(2)]).astype(np.float32)
    np.savez(tmp / "inputs.npz", **inp)
    (tmp / "inputs.json").write_text(json.dumps(dict(
        ks_ctx=KS_CTX, ks_levels=KS_LEVELS, diags=DIAGS,
        tiny_config=TINY_CONFIG)))
    return inp, (gctx, ev, trs), jnet


def _ref_keyswitch(inp):
    from orion_tpu.crypto import CKKSContext, KeyChest
    from orion_tpu.crypto.keyswitch import dev_level, keyswitch
    from orion_tpu.parallel.limbshard import make_sharded_keyswitch

    ref = {}
    ctx = CKKSContext(**KS_CTX)
    rk = KeyChest(ctx).relin_key
    for lvl in KS_LEVELS:
        c = inp[f"ks_c{lvl}"].astype(np.uint32)
        dl = dev_level(ctx, lvl)
        ref[f"ks_l{lvl}"] = np.asarray(jax.jit(
            lambda c, dl=dl: keyswitch(c, dl, rk.data, rk.shoup))(c))
        for m in (2, 4):
            sks = make_sharded_keyswitch(
                ctx, lvl, Mesh(np.array(jax.devices()[:m]), ("limb",)))
            kd, ks = sks.shard_ksk(rk.data, rk.shoup, ctx)
            ref[f"ks_m{m}_l{lvl}"] = np.asarray(
                sks.fn(sks.pad_poly(c), kd, ks))
    return ref


def _ref_dp_mp(inp, dpmp):
    from orion_tpu.parallel.mesh import encrypted_dp_mp_step

    _, ev, trs = dpmp
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "mp"))
    step = encrypted_dp_mp_step(ev, trs, mesh)
    return {"dpmp": np.asarray(jax.jit(step)(
        jnp.asarray(inp["dpmp_x"].astype(np.uint32))))}


def _ref_forward(inp, jnet):
    from orion_tpu.runtime.mesh import encrypt_batch, make_sharded_forward
    from orion_tpu.runtime.scheme import Scheme

    scheme = Scheme().init_scheme(TINY_CONFIG)
    jnet.eval()
    clear = [np.asarray(jnet(q)).reshape(-1) for q in inp["queries"]]
    scheme.fit(jnet, list(inp["fit"]), batch_size=16)
    level = scheme.compile(jnet)
    jnet.he()
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "limb"))
    outs = make_sharded_forward(jnet, scheme, mesh)(
        encrypt_batch(scheme, list(inp["queries"]), level))
    return {"clear": clear,
            "fwd": [[(np.asarray(ct.data).astype(np.int64), ct.level,
                      ct.scale) for ct in o.cts] for o in outs]}


def _reference(inp, dpmp, jnet):
    """orion_tpu's results on the conftest's virtual devices, jitted; the
    three programs trace and compile in threads of their own (XLA
    compiles outside the GIL), as orion_tpu's `aot_precompile_forward`
    compiles its module programs."""
    with ThreadPoolExecutor(3) as pool:
        parts = [pool.submit(_ref_keyswitch, inp),
                 pool.submit(_ref_dp_mp, inp, dpmp),
                 pool.submit(_ref_forward, inp, jnet)]
        ref = {}
        for part in parts:
            ref.update(part.result())
    return ref


def _world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world")
    inp, dpmp, jnet = _inputs(tmp)
    port = _free_port()
    env = {**os.environ, "ORION_REPO": str(ROOT), "LOCAL_WORLD_SIZE": "2",
           "TF_CPP_MIN_LOG_LEVEL": "3", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(WORLD), str(port),
         str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(WORLD)]
    try:
        prev = jax.config.read("jax_disable_most_optimizations")
        jax.config.update("jax_disable_most_optimizations", True)
        try:
            ref = _reference(inp, dpmp, jnet)
        finally:
            jax.config.update("jax_disable_most_optimizations", prev)
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {r} failed:\n{log[-4000:]}"
    ranks = [(dict(np.load(tmp / f"rank{r}.npz")),
              json.loads((tmp / f"rank{r}.json").read_text()))
             for r in range(WORLD)]
    return ref, ranks


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(orion_tpu's results, each rank's), computed once per test session
    (`shared`): the world of ranks and orion_tpu's programs are the file's
    whole cost."""
    return shared(tmp_path_factory, "parallel_world",
                  lambda: _world(tmp_path_factory))


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("level", KS_LEVELS)
def test_sharded_keyswitch_equals_orion_tpu(world, m, level):
    """Every rank's gathered result, by row blocks and by the seam, equals
    orion_tpu's sharded key-switch and the unsharded one residue for
    residue (Q rows; orion_tpu's output holds garbage in special rows)."""
    ref, ranks = world
    nl = level + 1
    want = ref[f"ks_l{level}"].astype(np.int64)
    sharded = ref[f"ks_m{m}_l{level}"].astype(np.int64)
    np.testing.assert_array_equal(sharded[:, :nl], want)
    for out, _ in ranks:
        np.testing.assert_array_equal(out[f"ks_fn_m{m}_l{level}"][:, :nl],
                                      want)
        np.testing.assert_array_equal(out[f"ks_seam_m{m}_l{level}"], want)


def test_dcn_mesh_layout_and_errors(world):
    _, ranks = world
    for _, rec in ranks:
        rep = rec["report"]
        assert rep["shape"] == {"dp": 2, "limb": 2}, rep
        assert rep["dp_crosses_hosts"] is True, rep
        assert rep["limb_crosses_hosts"] is False, rep
        assert rep["num_processes"] == 4 and rep["num_hosts"] == 2, rep
        assert rec["ranks"] == [[0, 1], [2, 3]]
        assert "not divisible by limb=3" in rec["limb3"]
        assert "uneven ranks per host" in rec["uneven"]
        assert rec["jax_imported"] is False


def test_dp_mp_step_equals_orion_tpu(world):
    ref, ranks = world
    want = ref["dpmp"].astype(np.int64)
    assert want.shape[:2] == (2, 2)
    for out, _ in ranks:
        np.testing.assert_array_equal(out["dpmp"], want)


def test_sharded_forward_equals_orion_tpu(world):
    ref, ranks = world
    for out, rec in ranks:
        for b, (cts, clear) in enumerate(zip(ref["fwd"], ref["clear"])):
            assert rec[f"fwd_q{b}_meta"] == [[lv, sc] for _, lv, sc in cts]
            for i, (data, _, _) in enumerate(cts):
                np.testing.assert_array_equal(out[f"fwd_q{b}_ct{i}"], data)
            got = np.asarray(rec[f"fwd_q{b}_dec"])[: clear.size]
            assert float(np.max(np.abs(got - clear))) < 5e-3


def test_sharded_bootstrap_equals_unsharded(world):
    _, ranks = world
    for _, rec in ranks:
        boot = rec["boot"]
        assert boot["limb"] == 2 and boot["bootstraps"] >= 1, boot
        assert boot["equal"] is True
        assert boot["err"] < 5e-3
