"""Scheme orchestrator: init_scheme / fit / compile / encode / encrypt.

Counterpart of `orion_tpu/runtime/scheme.py`.  The compile pipeline is the
same step for step: build DAG -> clone orion params -> fuse -> pack
diagonals (last linear forced to the square embedding) -> level assignment
and bootstrap placement -> per-module compile.

Device: `init_scheme(config, device=None)` puts every table, key and
ciphertext on `cuda`, where the hand-written kernels run; without a CUDA
device it raises unless the caller asks for `device="cpu"`, the plain
PyTorch path.

`io_mode: save` writes the keys and the packed diagonals during
`init_scheme` and `compile`, `load` reads them back (`runtime/io.py`).
`io_mode: stream` spills each module's compiled buffers to pinned host
memory right after the module compiles, and brings them back around each
leaf module's forward under a residency budget (`runtime/buffers.py`).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Union

import numpy as np
import yaml

from ..crypto import CKKSContext, Encoder, Evaluator, KeyChest
from ..nn.module import Module
from ..nn.linear import LinearTransform
from ..compiler.tracer import Tracer
from ..compiler.dag import NetworkDAG
from ..compiler.fuser import Fuser
from ..compiler.level_dag import BootstrapSolver, BootstrapPlacer
from . import buffers, io
from .config import Params, parse_config
from .services import (BootstrapperService, EncoderService,
                       EncryptorService, LTEvaluatorService,
                       PolyEvaluatorService)


class Scheme:
    def __init__(self):
        self.ctx = None
        self.tracer = None
        self.params: Params | None = None
        # runs each leaf module's he forward when set (io_mode stream)
        self.module_runner = None

    # ----------------- lifecycle ----------------- #

    def init_scheme(self, config: Union[str, Dict[str, Any]], device=None):
        if isinstance(config, str):
            with open(config) as f:
                config = yaml.safe_load(f)
        elif not isinstance(config, dict):
            raise TypeError("config must be a YAML path or a dict")
        self.params = parse_config(config)
        p = self.params
        self.tracer = None
        self.ctx = CKKSContext(
            logn=p.logn, logq=p.split_logq, logp=p.logp,
            logscale=p.logscale, h=p.h, ring_type=p.ring_type, seed=p.seed,
            device=device)
        self.enc = Encoder(self.ctx)
        self.keys = None
        if p.io_mode == "load" and p.keys_path:
            io.load_secret_key(self, p.keys_path)
        if self.keys is None:
            self.keys = KeyChest(self.ctx)
        if p.io_mode == "load" and p.keys_path:
            io.load_rotation_keys(self, p.keys_path)
        elif p.io_mode == "save" and p.keys_path:
            io.save_secret_key(self, p.keys_path)
        self.evaluator = Evaluator(self.ctx, self.keys)
        # deep bootstrapped chains: halve the key packs' memory (Montgomery
        # lift in the key inner product instead of stored Shoup companions)
        self.evaluator.lean_keys = bool(p.boot)
        self.input_level_default = self.ctx.max_level
        self.module_runner = (buffers.StreamRunner(self)
                              if p.io_mode == "stream" else None)

        self.encoder = EncoderService(self)
        self.encryptor = EncryptorService(self)
        self.lt_evaluator = LTEvaluatorService(self)
        self.poly_evaluator = PolyEvaluatorService(self)
        self.bootstrapper = BootstrapperService(self)
        return self

    def delete_scheme(self):
        """Drop everything the scheme holds (context, keys, key packs,
        services and the traced network, whose modules keep their encoded
        diagonals), so that its device memory can be released."""
        self.__dict__.clear()
        Scheme.__init__(self)

    # ----------------- user data path ----------------- #

    def encode(self, tensor, level=None, scale=None):
        self._check_init()
        return self.encoder.encode(tensor, level=level, scale=scale)

    def decode(self, ptxt):
        self._check_init()
        return self.encoder.decode(ptxt)

    def encrypt(self, ptxt):
        self._check_init()
        return self.encryptor.encrypt(ptxt)

    def decrypt(self, ctxt):
        self._check_init()
        return self.encryptor.decrypt(ctxt)

    # ----------------- fit ----------------- #

    def fit(self, net: Module, input_data, batch_size: int = 128):
        self._check_init()
        net.set_scheme(self)
        net.set_margin(self.params.margin)
        net.eval()

        tracer = Tracer(net)
        self.tracer = tracer

        print("\n{1} Finding per-layer input/output ranges and shapes...",
              flush=True)
        start = time.time()
        batches, user_batch = self._as_batches(input_data, batch_size)
        for batch in batches:
            tracer.propagate(batch)
        if user_batch is not None:
            tracer.update_batch_size(user_batch)
        print(f"done! [{time.time() - start:.3f} secs.]")

        print("\n{2} Fitting polynomials... ", end="", flush=True)
        start = time.time()
        for module in net.modules():
            if hasattr(module, "fit") and callable(module.fit):
                module.fit()
        print(f"done! [{time.time() - start:.3f} secs.]")

    @staticmethod
    def _as_batches(input_data, batch_size):
        """Accept an array or tensor, or (x, y) batch iterables.

        Loader inputs are re-batched to `batch_size` for the statistics
        pass and the layer shapes are reset to the loader's own batch size
        afterwards.  Returns (batches, user_batch_size or None).
        """
        if hasattr(input_data, "shape"):
            return [input_data], None
        xs = []
        user_batch = None
        for item in input_data:
            x = item[0] if isinstance(item, (tuple, list)) else item
            x = np.asarray(x)
            if user_batch is None:
                user_batch = x.shape[0]
            xs.append(x)
        user_batch = getattr(input_data, "batch_size", user_batch)
        all_x = np.concatenate(xs, axis=0)
        big = max(batch_size, user_batch)
        batches = [all_x[i:i + big] for i in range(0, len(all_x), big)]
        return batches, user_batch

    # ----------------- compile ----------------- #

    def compile(self, net: Module):
        self._check_init()
        if self.tracer is None:
            raise ValueError(
                "Network has not been fit yet! Run fit(net, input_data) "
                "before compile(net).")

        dag = NetworkDAG(self.tracer).build_dag()

        for module in net.modules():
            if hasattr(module, "init_orion_params"):
                module.init_orion_params()
        for module in net.modules():
            if hasattr(module, "update_params"):
                module.update_params()

        if self.params.fuse_modules:
            Fuser(dag).fuse_modules()
            dag.remove_fused_batchnorms()
        if self.params.io_mode == "save" and self.params.diags_path:
            io.start_archive(self.params.diags_path)

        # pack diagonals; the last linear layer uses the square embedding so
        # no replicated partials leak
        topo = list(dag.topological_sort())
        last_linear = None
        for node in reversed(topo):
            if isinstance(dag.nodes[node]["module"], LinearTransform):
                last_linear = node
                break
        print("\n{3} Generating matrix diagonals...", flush=True)
        for node in topo:
            module = dag.nodes[node]["module"]
            if isinstance(module, LinearTransform):
                print(f"packing {node}...", flush=True)
                module.generate_diagonals(last=(node == last_linear))

        print("\n{4} Running bootstrap placement... ", end="", flush=True)
        start = time.time()
        solver = BootstrapSolver(net, dag, l_eff=self.params.l_eff,
                                 slots=self.ctx.slots,
                                 base_level=self.params.base_level,
                                 bootstrap=bool(self.params.boot))
        input_level, num_btp, btp_slots = solver.solve()
        print(f"done! [{time.time() - start:.3f} secs.]")
        print(f"network requires {num_btp} bootstrap operation(s)")
        # the galois elements each linear module will ask keys for, so
        # that a key is freed as soon as the last module that needs it has
        # built its packs (not all at the end: the keys of a deep net
        # would otherwise all sit on the card together)
        pending = {}
        for node in topo:
            module = dag.nodes[node]["module"]
            if isinstance(module, LinearTransform):
                pending[node] = {
                    self.ctx.galois_element(r)
                    for r in self.lt_evaluator.layer_rotations(module)}
        keep = self._kept_keys(net)
        for slot_count in btp_slots:
            self.bootstrapper.generate_bootstrapper(slot_count)
        freed = self._free_packed_keys(keep, pending)
        BootstrapPlacer(net, dag, solver).place_bootstraps()

        # per-module compile in topological order.  With io_mode stream,
        # each module's buffers (and its post_bootstrap's) are spilled to
        # host memory right after its compile, so the card holds one
        # module's working set instead of the whole net's
        print("\n{5} Compiling network layers...", flush=True)
        stream = self.params.io_mode == "stream"
        spilled = 0
        for node in topo:
            if node not in dag.nodes:
                continue  # removed fused BN
            module = dag.nodes[node]["module"]
            if isinstance(module, Module):
                print(f"|-- {node} @ level={module.level}", flush=True)
                module.compile()
                pb = getattr(module, "post_bootstrap", None)
                if pb is not None:
                    pb.compile()
                if stream:
                    spilled += buffers.spill_module_to_host(self, module)
                    if pb is not None:
                        spilled += buffers.spill_module_to_host(self, pb)
            pending.pop(node, None)
            freed += self._free_packed_keys(keep, pending)
        if freed:
            print(f"|-- freed {freed} original rotation keys "
                  "(retained in pre-permuted packs)", flush=True)
        if stream:
            self.spilled_bytes = spilled
            print(f"|-- streamed {spilled / 1e9:.2f} GB of compiled buffers "
                  "to host (io_mode: stream)", flush=True)
        if self._saving_keys():
            io.save_rotation_keys(self, self.params.keys_path)
        self.input_level = input_level
        return input_level

    def _kept_keys(self, net):
        """Galois elements whose keys stay in original form: conjugation
        and the hybrid embedding's output rotations (CipherTensor.roll
        path); any other rotation asked for after compile is regenerated
        lazily."""
        keep = {self.ctx.galois_element_conj()}
        for module in net.modules():
            for i in range(1, getattr(module, "output_rotations", 0) + 1):
                keep.add(self.ctx.galois_element(self.ctx.slots // (2 ** i)))
        return keep

    def _free_packed_keys(self, keep, pending):
        """Free the original galois keys whose rotations live on inside
        pre-permuted KeyPacks, unless kept or still asked for by a module
        in `pending` (node -> galois elements).  Returns how many."""
        needed = keep.union(*pending.values())
        packed = {self.ctx.galois_element(a)
                  for pack in self.evaluator._key_packs.values()
                  for a in pack.amounts}
        drop = [k for k in self.keys.galois_keys
                if k in packed and k not in needed]
        if drop and self._saving_keys():
            # io_mode save: a key is written before it is freed
            io.save_galois_keys(self, self.params.keys_path,
                                {k: self.keys.galois_keys[k] for k in drop})
        for k in drop:
            del self.keys.galois_keys[k]
        return len(drop)

    def _saving_keys(self) -> bool:
        return self.params.io_mode == "save" and bool(self.params.keys_path)

    def _check_init(self):
        if self.ctx is None:
            raise ValueError(
                "Scheme not initialized. Call init_scheme() first.")


scheme = Scheme()
