"""io_mode: save/load of the secret key, the evaluation keys and the packed
diagonals, as numpy archives.

Counterpart of `orion_tpu/runtime/io.py`: `io_mode: save` writes them
during `init_scheme` and `compile`; `load` reads them back instead of
generating keys and packing diagonals, after the same parameter and
secret-key checks, with the same messages.

orion_tpu writes HDF5 through h5py.  The machine with the card has no
h5py, so the port writes numpy archives (`.npz`: a zip of `.npy`
members), read with `allow_pickle=False`.  Member names are orion_tpu's
HDF5 paths: the datasets `secret_key`, `rotation_keys/relin`,
`rotation_keys/galois_<k>`, and per layer `<layer>/on_bias` and
`<layer>/diagonals/<row>_<col>/<idx>`; the HDF5 attribute `A` of object
`P` is the member `P@A` (the fingerprints as 0-d strings, the layer's
`output_rotations`, `input_shape` and `output_shape` as integers).  The
arrays hold orion_tpu's values and types (keys as uint32 residues).

Keys: the port's compile frees each packed rotation key as soon as no
later module needs it (`runtime/scheme.py`), so `save` writes a key just
before it is freed and the keys left, with the relinearisation key, at
the end of compile (orion_tpu writes them all at the end of its compile,
before its own trim).  `load` reads the relinearisation key at
`init_scheme` and each rotation key when it is first asked for, which
recomputes its Shoup companions on the device (key packs of bootstrapped
configs drop them again for the lean Montgomery form); a rotation the
archive lacks is generated, as in orion_tpu.  Members are appended to an
archive and never replaced: the secret key starts a new key archive and a
`save` compile a new diagonal archive.
"""

from __future__ import annotations

import hashlib
import os
import zipfile

import numpy as np


def _params_fingerprint(params) -> str:
    return (f"logn={params.logn};logq={params.logq};logp={params.logp};"
            f"logscale={params.logscale};h={params.h};"
            f"embed={params.embedding_method}")


def _sk_digest(scheme) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(scheme.keys.s_coeff)).hexdigest()[:16]


def _keys_fingerprint(scheme) -> str:
    return _params_fingerprint(scheme.params) + ";sk=" + _sk_digest(scheme)


# ------------------------------ archives ------------------------------ #

def start_archive(path: str):
    """An empty archive at `path` (its directory made, a file there
    removed)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with zipfile.ZipFile(path, "w"):
        pass


def append(path: str, arrays: dict):
    """Append name -> array members the archive does not hold yet (a
    name it holds keeps its first array)."""
    if not os.path.exists(path):
        start_archive(path)
    with zipfile.ZipFile(path, "a") as zf:
        have = set(zf.namelist())
        for name, arr in arrays.items():
            member = name + ".npy"
            if member in have:
                continue
            with zf.open(member, "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr),
                                          allow_pickle=False)
            have.add(member)


def read(path: str):
    """The archive's members, lazily (a `numpy.lib.npyio.NpzFile`)."""
    return np.load(path, allow_pickle=False)


def _text(x) -> str:
    return str(x[()])


# ----------------------------- secret key ----------------------------- #

def save_secret_key(scheme, path: str):
    """Start the key archive with the secret key and its fingerprint."""
    start_archive(path)
    append(path, {"secret_key": scheme.keys.s_coeff,
                  "secret_key@fingerprint":
                      np.array(_params_fingerprint(scheme.params))})


def load_secret_key(scheme, path: str) -> bool:
    """Rebuild the scheme's KeyChest from a saved secret key."""
    if not os.path.exists(path):
        return False
    with read(path) as f:
        if "secret_key" not in f.files:
            return False
        fp = _text(f["secret_key@fingerprint"])
        if fp != _params_fingerprint(scheme.params):
            raise ValueError(
                "saved secret key was generated under different parameters; "
                "delete the keys file or fix the config "
                f"({fp!r})")
        s = f["secret_key"]
    from ..crypto.keys import KeyChest
    scheme.keys = KeyChest(scheme.ctx, secret=s)
    return True


# --------------------------- rotation keys --------------------------- #

def _key_array(key) -> np.ndarray:
    return key.data.cpu().numpy().astype(np.uint32)


def save_galois_keys(scheme, path: str, keys: dict):
    """Write Galois keys (element -> KeySwitchKey) not yet in the archive:
    compile calls this just before it frees them."""
    append(path, {f"rotation_keys/galois_{int(k)}": _key_array(v)
                  for k, v in keys.items()})


def save_rotation_keys(scheme, path: str):
    """The evaluation keys left at the end of compile: the fingerprint
    (parameters and secret-key digest), the relinearisation key and every
    Galois key not written yet."""
    append(path, {"rotation_keys@fingerprint":
                  np.array(_keys_fingerprint(scheme)),
                  "rotation_keys/relin": _key_array(scheme.keys.relin_key)})
    save_galois_keys(scheme, path, scheme.keys.galois_keys)


class KeyArchive:
    """The Galois keys of a key archive, read when first asked for."""

    def __init__(self, ctx, path: str, elements):
        self.ctx = ctx
        self.path = path
        self.elements = set(elements)

    def galois_key(self, k: int):
        """Galois element k's key from the archive, or None."""
        if k not in self.elements:
            return None
        with read(self.path) as f:
            return device_key(self.ctx, f[f"rotation_keys/galois_{k}"])


def device_key(ctx, data: np.ndarray):
    """A saved key's residues as a KeySwitchKey on the context's device;
    its Shoup companions are recomputed there."""
    from ..crypto.keys import KeySwitchKey
    p = ctx.to_device(np.asarray(ctx.primes[:data.shape[2]])[:, None])
    return KeySwitchKey(ctx.to_device(data.astype(np.int64)), p)


def load_rotation_keys(scheme, path: str) -> bool:
    """Take the relinearisation key from a saved archive and read each
    Galois key from it on first use (see the module docstring)."""
    if not os.path.exists(path):
        return False
    with read(path) as f:
        if "rotation_keys@fingerprint" not in f.files:
            return False
        if _text(f["rotation_keys@fingerprint"]) != _keys_fingerprint(scheme):
            raise ValueError(
                "saved rotation keys belong to different parameters or a "
                "different secret key; regenerate with io_mode: save")
        prefix = "rotation_keys/galois_"
        elements = [int(n[len(prefix):]) for n in f.files
                    if n.startswith(prefix)]
        relin = f["rotation_keys/relin"]
    scheme.keys.relin_key = device_key(scheme.ctx, relin)
    scheme.keys.stored = KeyArchive(scheme.ctx, path, elements)
    return True


# ----------------------------- diagonals ----------------------------- #

def _layer_name(layer) -> str:
    return layer.name or type(layer).__name__


def save_layer_diagonals(params, layer, path: str):
    name = _layer_name(layer)
    arrays = {
        f"{name}@fingerprint": np.array(_params_fingerprint(params)),
        f"{name}@output_rotations": np.array(int(layer.output_rotations)),
        f"{name}@input_shape": np.array(list(layer.input_shape), np.int64),
        f"{name}@output_shape": np.array(list(layer.output_shape),
                                         np.int64),
        f"{name}/on_bias": np.asarray(layer.on_bias),
    }
    for (row, col), diags in layer.diagonals.items():
        for idx, vec in diags.items():
            arrays[f"{name}/diagonals/{row}_{col}/{int(idx)}"] = \
                np.asarray(vec)
    append(path, arrays)


def load_layer_diagonals(params, layer, path: str) -> bool:
    if not os.path.exists(path):
        return False
    name = _layer_name(layer)
    with read(path) as f:
        if f"{name}@fingerprint" not in f.files:
            return False
        if _text(f[f"{name}@fingerprint"]) != _params_fingerprint(params):
            raise ValueError(
                f"saved diagonals for {name} use different parameters; "
                "regenerate with io_mode: save")
        layer.output_rotations = int(f[f"{name}@output_rotations"])
        layer.on_bias = f[f"{name}/on_bias"]
        prefix = f"{name}/diagonals/"
        diagonals = {}
        # members in the order they were written: the packing's order
        for member in f.files:
            if not member.startswith(prefix):
                continue
            block, idx = member[len(prefix):].split("/")
            row, col = map(int, block.split("_"))
            diagonals.setdefault((row, col), {})[int(idx)] = f[member]
        layer.diagonals = diagonals
    return True
