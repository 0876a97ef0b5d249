"""Cleartext training of orion_tpu_torch networks.

Counterpart of `orion_tpu/train.py` (SGD train/test loops with
best-checkpoint saving; FHE is inference-only, training runs in
cleartext).  The module graph is traced once, then turned into a
functional forward over a parameter dict, {layer: {"w", "b", "g"}}, and
BatchNorm running statistics, {layer: {"mean", "var"}}: the same layout
as orion_tpu's pytrees, so checkpoints cross between the packages.
Gradients come from PyTorch's autograd on the device the caller asks for
(`cuda` unless `device="cpu"`).

Polynomial activations train through their smooth source functions, and
ReLU through max(x, 0), as orion_tpu does; the polynomials are fitted
afterwards.  BatchNorm in training normalises by the biased batch
variance and updates both running statistics as (1 - mom) * s + mom *
batch, as orion_tpu does (`F.batch_norm` would update the running
variance with the unbiased one).  The trainer sets no backend flag: on
the card cuDNN's convolutions run in TF32 by PyTorch's default.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .compiler.tracer import Tracer
from .crypto.placement import resolve_device
from .nn import (Add, AdaptiveAvgPool2d, AvgPool2d, BatchNormNd, Chebyshev,
                 Conv2d, ELU, Flatten, GELU, Hardshrink, Identity, Linear,
                 Mish, Mult, Quad, ReLU, SELU, Sigmoid, SiLU, Softplus)
from .nn.activation import Activation, _Sign
from .nn.module import Module


def _tensor(v, device) -> torch.Tensor:
    """A copy of a parameter, statistic or batch (tensor or array) as
    float32 on device: the functional form never aliases a module's own
    storage."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(device=device, dtype=torch.float32, copy=True)
    return torch.tensor(np.asarray(v, np.float32), device=device)


# ------------------------------------------------------------------ #
#  Functional compilation                                            #
# ------------------------------------------------------------------ #

def _source_function(module):
    """The smooth function a Chebyshev activation approximates."""
    if isinstance(module, SiLU):
        return F.silu
    if isinstance(module, GELU):
        return lambda x: F.gelu(x, approximate="tanh")
    if isinstance(module, Sigmoid):
        return torch.sigmoid
    if isinstance(module, SELU):
        return F.selu
    if isinstance(module, Softplus):
        return F.softplus
    if isinstance(module, Mish):
        return lambda x: x * torch.tanh(F.softplus(x))
    if isinstance(module, ELU):
        alpha = module.alpha
        return lambda x: F.elu(x, alpha)
    if isinstance(module, Hardshrink):
        lam = module.lambd
        return lambda x: torch.where((x > lam) | (x < -lam), x,
                                     torch.zeros_like(x))
    raise NotImplementedError(
        f"no torch form for {type(module).__name__}; training uses the "
        "smooth source function")


def _leaf_apply(module, device):
    """Returns (params, state, fn(params, state, xs, train))."""

    def weights(**names):
        return {k: _tensor(getattr(module, attr), device)
                for k, attr in names.items()
                if getattr(module, attr, None) is not None}

    if isinstance(module, Linear):
        def fn(p, s, xs, train):
            return F.linear(xs[0].reshape(xs[0].shape[0], -1), p["w"],
                            p.get("b")), s
        return weights(w="weight", b="bias"), {}, fn

    if isinstance(module, AdaptiveAvgPool2d):
        ho, wo = module.output_size

        def fn(p, s, xs, train):
            n, c, h, w = xs[0].shape
            return xs[0].reshape(n, c, ho, h // ho, wo, w // wo).mean(
                dim=(3, 5)), s
        return {}, {}, fn

    if isinstance(module, AvgPool2d):
        kernel, stride, pad = (module.kernel_size, module.stride,
                               module.padding)

        def fn(p, s, xs, train):
            return F.avg_pool2d(xs[0], kernel, stride, pad,
                                count_include_pad=True), s
        return {}, {}, fn

    if isinstance(module, Conv2d):
        stride, pad, dil, groups = (module.stride, module.padding,
                                    module.dilation, module.groups)

        def fn(p, s, xs, train):
            return F.conv2d(xs[0], p["w"], p.get("b"), stride, pad, dil,
                            groups), s
        return weights(w="weight", b="bias"), {}, fn

    if isinstance(module, BatchNormNd):
        params = weights(g="weight", b="bias") if module.affine else {}
        state = {"mean": _tensor(module.running_mean, device),
                 "var": _tensor(module.running_var, device)}
        eps, mom = module.eps, module.momentum

        def fn(p, s, xs, train):
            x = xs[0]
            shape = (1, -1) + (1,) * (x.dim() - 2)
            if train:
                axes = (0,) + tuple(range(2, x.dim()))
                mean = x.mean(dim=axes)
                var = x.var(dim=axes, unbiased=False)
                new_s = {"mean": (1 - mom) * s["mean"] + mom * mean.detach(),
                         "var": (1 - mom) * s["var"] + mom * var.detach()}
            else:
                mean, var = s["mean"], s["var"]
                new_s = s
            out = (x - mean.reshape(shape)) * torch.rsqrt(
                var.reshape(shape) + eps)
            if p:
                out = out * p["g"].reshape(shape) + p["b"].reshape(shape)
            return out, new_s
        return params, state, fn

    if isinstance(module, Quad):
        return {}, {}, lambda p, s, xs, train: (xs[0] * xs[0], s)

    if isinstance(module, ReLU):
        return {}, {}, lambda p, s, xs, train: (F.relu(xs[0]), s)

    if isinstance(module, Chebyshev):
        g = _source_function(module)
        return {}, {}, lambda p, s, xs, train: (g(xs[0]), s)

    if isinstance(module, Activation):
        coeffs = list(module.coeffs)

        def fn(p, s, xs, train):
            out = torch.zeros_like(xs[0])
            for c in coeffs:  # Horner, highest power first
                out = c + xs[0] * out
            return out, s
        return {}, {}, fn

    if isinstance(module, Add):
        return {}, {}, lambda p, s, xs, train: (xs[0] + xs[1], s)

    if isinstance(module, Mult):
        return {}, {}, lambda p, s, xs, train: (xs[0] * xs[1], s)

    if isinstance(module, Flatten):
        return {}, {}, lambda p, s, xs, train: (
            xs[0].reshape(xs[0].shape[0], -1), s)

    if isinstance(module, (Identity, _Sign)):
        return {}, {}, lambda p, s, xs, train: (xs[0], s)

    raise NotImplementedError(
        f"no functional form for {type(module).__name__}")


def build_functional(net: Module, sample, device=None):
    """Trace the net and return (apply, params, state, modules_by_name).

    apply(params, state, x, train) -> (logits, new_state), differentiable
    in params; params and state are fresh tensors on `device` (`cuda`
    unless `device="cpu"`), for each a requires_grad leaf in params.
    """
    dev = resolve_device(device)
    # ReLU's sub-structure (mult/sign) is not traced as separate leaves
    # for training: ReLU itself (and a bare _Sign) is the leaf
    orig = Module.is_leaf

    def patched(self):
        if isinstance(self, (ReLU, _Sign)):
            return True
        return orig(self)

    Module.is_leaf = patched
    try:
        tracer = Tracer(net)
        net.eval()
        tracer.propagate(sample)
    finally:
        Module.is_leaf = orig

    order = [n for n in tracer.order if n != "_input"]
    nodes = tracer.nodes
    params, state, fns = {}, {}, {}
    for name in order:
        p, s, fn = _leaf_apply(nodes[name].module, dev)
        if p:
            params[name] = {k: v.requires_grad_() for k, v in p.items()}
        if s:
            state[name] = s
        fns[name] = fn

    out_node = tracer.output_node

    def apply(params, state, x, train=False):
        vals = {"_input": _tensor(x, dev)}
        new_state = dict(state)
        for name in order:
            xs = [vals[p] for p in nodes[name].parents]
            y, ns = fns[name](params.get(name, {}),
                              new_state.get(name, {}), xs, train)
            if ns:
                new_state[name] = ns
            vals[name] = y
        return vals[out_node], new_state

    modules = {name: nodes[name].module for name in order}
    return apply, params, state, modules


def write_back(net: Module, params, state, modules):
    """Copy trained parameters and statistics (tensors or arrays) back into
    the modules' Parameters and buffers."""
    def put(dst, v):
        with torch.no_grad():
            dst.copy_(_tensor(v, dst.device).reshape(dst.shape))

    for name, module in modules.items():
        p = params.get(name, {})
        if isinstance(module, (Linear, Conv2d)) and "w" in p:
            put(module.weight, p["w"])
            if module.bias is not None and "b" in p:
                put(module.bias, p["b"])
        if isinstance(module, BatchNormNd):
            s = state.get(name)
            if s is not None:
                put(module.running_mean, s["mean"])
                put(module.running_var, s["var"])
            if module.affine and p:
                put(module.weight, p["g"])
                put(module.bias, p["b"])


# ------------------------------------------------------------------ #
#  Train / test loops                                                #
# ------------------------------------------------------------------ #

def save_checkpoint(params, path):
    """Flatten a params dict ({layer: {k: tensor or array}}) into one .npz
    file keyed "layer/param" (orion_tpu's format: either package reads the
    other's checkpoints)."""
    flat = {}
    for name, p in params.items():
        for k, v in p.items():
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            flat[f"{name}/{k}"] = np.asarray(v)
    np.savez(path, **flat)


def load_checkpoint(path):
    """Inverse of save_checkpoint: returns the nested params dict (numpy)."""
    params: dict = {}
    with np.load(path) as data:
        for key in data.files:
            name, k = key.rsplit("/", 1)
            params.setdefault(name, {})[k] = np.asarray(data[key])
    return params


def train(net: Module, trainloader, testloader=None, epochs: int = 1,
          lr: float = 0.05, momentum: float = 0.9, weight_decay: float = 5e-4,
          checkpoint_path: str | None = None, log_every: int = 50,
          device=None):
    """SGD with momentum and weight decay on the cross-entropy loss.

    `torch.optim.SGD` adds the decay to the gradient, starts its momentum
    buffer at the first gradient and steps p -= lr * buffer: orion_tpu's
    optax chain (add_decayed_weights, sgd with momentum) step for step."""
    sample = next(iter(trainloader))[0]
    apply, params, state, modules = build_functional(
        net, np.asarray(sample), device=device)
    dev = resolve_device(device)
    flat = [v for p in params.values() for v in p.values()]
    opt = torch.optim.SGD(flat, lr=lr, momentum=momentum,
                          weight_decay=weight_decay)

    best_acc = -1.0
    for epoch in range(epochs):
        losses = []
        for i, (x, y) in enumerate(trainloader):
            opt.zero_grad(set_to_none=True)
            logits, state = apply(params, state, x, train=True)
            labels = torch.as_tensor(np.asarray(y), dtype=torch.long,
                                     device=dev)
            loss = F.cross_entropy(logits, labels)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            if log_every and i % log_every == 0:
                print(f"epoch {epoch} step {i}: loss {losses[-1]:.4f}")
        if testloader is None:
            continue
        correct = total = 0
        with torch.no_grad():
            for x, y in testloader:
                logits, _ = apply(params, state, x, train=False)
                pred = logits.argmax(dim=-1).cpu().numpy()
                correct += int((pred == np.asarray(y)).sum())
                total += len(np.asarray(y))
        acc = correct / max(total, 1)
        print(f"epoch {epoch}: loss {np.mean(losses):.4f} "
              f"test acc {acc:.4f}")
        if checkpoint_path and acc > best_acc:
            best_acc = acc
            save_checkpoint(params, checkpoint_path)
    write_back(net, params, state, modules)
    return net


def train_on_mnist(net, data_dir="./data", epochs=1, batch_size=128, **kw):
    from .utils import get_mnist_datasets
    tr, te = get_mnist_datasets(data_dir, batch_size=batch_size)
    return train(net, tr, te, epochs=epochs, **kw)


def train_on_cifar(net, data_dir="./data", epochs=1, batch_size=128, **kw):
    from .utils import get_cifar_datasets
    tr, te = get_cifar_datasets(data_dir, batch_size=batch_size)
    return train(net, tr, te, epochs=epochs, **kw)
