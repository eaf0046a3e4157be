"""The paper's backbones in PyTorch: mnist_2NN, a tiny MLP, the CIFAR CNN and
ResNet-18 with GroupNorm — the port of ``repro.models.small``.

Parameters are nested dicts of tensors in the reference layouts: dense
``w`` is ``(n_in, n_out)``, conv weights are HWIO and inputs NHWC.  Each
``apply`` transposes to PyTorch's NCHW/OIHW inside, so a flat bank row
(leaves in sorted-key order, as ``jax.tree`` flattens a dict) means the
same model in both packages.  Each model exposes ``init(generator) ->
params``, ``apply(params, x) -> logits`` and ``loss(params, batch) ->
(ce_loss, accuracy)``; all three are plain functions, so ``torch.func``
can take gradients and vmap them over the bank rows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["Model", "mnist_2nn", "tiny_mlp", "cifar_cnn", "resnet18_gn",
           "get_model", "_softmax_xent"]


def _normal(gen, shape, scale):
    return scale * torch.randn(
        shape, generator=gen, device=gen.device, dtype=torch.float32
    )


def _dense_init(gen, n_in, n_out, scale=None):
    scale = scale or math.sqrt(2.0 / n_in)
    return {
        "w": _normal(gen, (n_in, n_out), scale),
        "b": torch.zeros((n_out,), dtype=torch.float32, device=gen.device),
    }


def _conv_init(gen, kh, kw, c_in, c_out):
    return {
        "w": _normal(gen, (kh, kw, c_in, c_out), math.sqrt(2.0 / (kh * kw * c_in))),
        "b": torch.zeros((c_out,), dtype=torch.float32, device=gen.device),
    }


def _gn_init(c, device):
    return {"scale": torch.ones((c,), dtype=torch.float32, device=device),
            "bias": torch.zeros((c,), dtype=torch.float32, device=device)}


def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``padding="SAME"``: output ceil(size / stride), the odd pixel of
    padding on the high side — (0, 1) for a 3x3 stride-2 conv on 32 wide,
    where PyTorch's ``padding=1`` would pad both sides."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, p, stride=1):
    """NCHW activations, an HWIO weight, SAME padding."""
    w = p["w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
    kh, kw = w.shape[2], w.shape[3]
    top, bottom = _same_pad(x.shape[2], kh, stride)
    left, right = _same_pad(x.shape[3], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w, p["b"], stride=stride)


def _group_norm(x, p, groups=8, eps=1e-5):
    """GroupNorm over contiguous channel groups, biased variance (NCHW)."""
    n, c, h, w = x.shape
    g = min(groups, c)
    xg = x.reshape(n, g, c // g, h, w)
    mean = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(2, 3, 4), keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    return (xg.reshape(n, c, h, w) * p["scale"][:, None, None]
            + p["bias"][:, None, None])


def _softmax_xent(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(logp, 1, labels.long()[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return ce, acc


def _dense(x, p):
    return x @ p["w"] + p["b"]


@dataclasses.dataclass(frozen=True)
class Model:
    name: str
    init: Callable
    apply: Callable

    def loss(self, params, batch):
        logits = self.apply(params, batch["x"])
        return _softmax_xent(logits, batch["y"])


# mnist_2NN: 784 -> 200 -> 200 -> 10 (Sun et al. 2022).

def mnist_2nn(n_classes: int = 10, in_dim: int = 784) -> Model:
    def init(gen):
        return {
            "fc1": _dense_init(gen, in_dim, 200),
            "fc2": _dense_init(gen, 200, 200),
            "out": _dense_init(gen, 200, n_classes),
        }

    def apply(params, x):
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(_dense(x, params["fc1"]))
        x = torch.relu(_dense(x, params["fc2"]))
        return _dense(x, params["out"])

    return Model("mnist_2nn", init, apply)


# Deliberately small MLP for population-scale tests.

def tiny_mlp(in_dim: int = 32, hidden: int = 32, n_classes: int = 10) -> Model:
    def init(gen):
        return {
            "fc1": _dense_init(gen, in_dim, hidden),
            "out": _dense_init(gen, hidden, n_classes),
        }

    def apply(params, x):
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(_dense(x, params["fc1"]))
        return _dense(x, params["out"])

    return Model("tiny_mlp", init, apply)


# CIFAR CNN: conv5x5(64) - pool - conv5x5(64) - pool - fc384 - fc192 - out
# (paper Appendix A).

def cifar_cnn(n_classes: int = 10, image: tuple = (32, 32, 3)) -> Model:
    h, w, c = image
    flat = (h // 4) * (w // 4) * 64

    def init(gen):
        return {
            "conv1": _conv_init(gen, 5, 5, c, 64),
            "conv2": _conv_init(gen, 5, 5, 64, 64),
            "fc1": _dense_init(gen, flat, 384),
            "fc2": _dense_init(gen, 384, 192),
            "out": _dense_init(gen, 192, n_classes),
        }

    def apply(params, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.max_pool2d(torch.relu(_conv(x, params["conv1"])), 2, 2)
        x = F.max_pool2d(torch.relu(_conv(x, params["conv2"])), 2, 2)
        # Flatten in the reference's NHWC order, so fc1's rows line up.
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = torch.relu(_dense(x, params["fc1"]))
        x = torch.relu(_dense(x, params["fc2"]))
        return _dense(x, params["out"])

    return Model("cifar_cnn", init, apply)


# ResNet-18 with GroupNorm.

_STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))  # (width, first stride)


def resnet18_gn(n_classes: int = 10, image: tuple = (32, 32, 3),
                width_mult: float = 1.0) -> Model:
    widths = [max(int(w * width_mult), 8) for w, _ in _STAGES]

    def init(gen):
        dev = gen.device
        params = {
            "stem": _conv_init(gen, 3, 3, image[2], widths[0]),
            "stem_gn": _gn_init(widths[0], dev),
        }
        c_in = widths[0]
        for s, ((_, stride), c_out) in enumerate(zip(_STAGES, widths)):
            for b in range(2):
                blk = {
                    "conv1": _conv_init(gen, 3, 3, c_in, c_out),
                    "gn1": _gn_init(c_out, dev),
                    "conv2": _conv_init(gen, 3, 3, c_out, c_out),
                    "gn2": _gn_init(c_out, dev),
                }
                if c_in != c_out or (b == 0 and stride != 1):
                    blk["proj"] = _conv_init(gen, 1, 1, c_in, c_out)
                    blk["proj_gn"] = _gn_init(c_out, dev)
                params[f"s{s}b{b}"] = blk
                c_in = c_out
        params["head"] = _dense_init(gen, c_in, n_classes)
        return params

    def block(x, p, stride):
        y = _conv(x, p["conv1"], stride=stride)
        y = torch.relu(_group_norm(y, p["gn1"]))
        y = _conv(y, p["conv2"])
        y = _group_norm(y, p["gn2"])
        if "proj" in p:
            x = _group_norm(_conv(x, p["proj"], stride=stride), p["proj_gn"])
        return torch.relu(x + y)

    def apply(params, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = torch.relu(_group_norm(_conv(x, params["stem"]), params["stem_gn"]))
        for s, (_, stride) in enumerate(_STAGES):
            for b in range(2):
                x = block(x, params[f"s{s}b{b}"], stride if b == 0 else 1)
        x = x.mean(dim=(2, 3))
        return _dense(x, params["head"])

    return Model("resnet18_gn", init, apply)


def get_model(name: str, n_classes: int, image=(32, 32, 3)) -> Model:
    if name == "mnist_2nn":
        return mnist_2nn(n_classes, int(math.prod(image)))
    if name == "cifar_cnn":
        return cifar_cnn(n_classes, image)
    if name == "resnet18_gn":
        return resnet18_gn(n_classes, image)
    raise ValueError(name)
