"""Weights drawn from the run's seed on the device, in a few large calls,
into the flax-layout `{"params", "batch_stats"}` tree that both the port's
`params.load_variables` and the reference's take.

The distributions are those of the port's `params.init_variables` /
`init_votenet_variables`, the draw that makes a forward do real work at
full size: kernels normal at the kaiming scale (fan-out for a sparse conv
[K, Cin, Cout], fan-in for a dense [in, out]) or at `gain / sqrt(fan_in)`
where the family names a gain; norm gains uniform in [0.5, 1.5] (times a
residual gain), other biases normal with deviation 0.1 but the family's
zero ones, the heads' exp scales one; running means normal with deviation
0.1, running variances uniform in [0.5, 2]. The draw itself differs from
the port's (a torch generator on the card, not numpy), so the same seed
gives other numbers than the port's functions."""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

Shapes = Dict[str, Tuple[int, ...]]


def _rule(name: str, shape, gains: Mapping[str, float], zero_bias,
          residual_gain: Mapping[str, float]):
    """(distribution, scale, offset) of one leaf: the leaf is `offset +
    scale * x`, x from "normal" (unit), "uniform" (on [0, 1)) or "const"."""
    module, _, leaf = name.rpartition(".")
    owner = module.rsplit(".", 1)[-1]
    if leaf == "kernel":
        gain = gains.get(module, gains.get(owner))
        fan_in = shape[-2] if len(shape) == 3 else int(np.prod(shape[:-1]))
        if gain is not None:
            return "normal", gain / np.sqrt(fan_in), 0.0
        if len(shape) == 3:
            return "normal", np.sqrt(2.0 / (shape[0] * shape[2])), 0.0
        return "normal", np.sqrt(2.0 / fan_in), 0.0
    if leaf.startswith("scale_") or not module:
        return "const", 0.0, 1.0
    if leaf == "bias" and owner in zero_bias:
        return "const", 0.0, 0.0
    if leaf == "scale":
        g = residual_gain.get(owner, 1.0)
        return "uniform", g, 0.5 * g
    if leaf == "bias":
        return "normal", 0.1, 0.0
    if leaf == "mean":
        return "normal", 0.1, 0.0
    if leaf == "var":
        return "uniform", 1.5, 0.5
    raise ValueError(f"no draw rule for {name}")


def draw(shapes: Tuple[Shapes, Shapes], seed: int, device,
         gains: Mapping[str, float], zero_bias,
         residual_gain: Optional[Mapping[str, float]] = None) -> dict:
    """The tree of ({param: shape}, {batch stat: shape}) drawn on `device`
    from `seed`, its leaves f32 views of one host buffer."""
    pshapes, sshapes = shapes
    names = sorted(pshapes) + sorted(sshapes)
    shape_of = {**pshapes, **sshapes}
    rules = {n: _rule(n, shape_of[n], gains, zero_bias, residual_gain or {})
             for n in names}
    sizes = {n: int(np.prod(shape_of[n], dtype=np.int64)) for n in names}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    total = {kind: sum(sizes[n] for n in names if rules[n][0] == kind)
             for kind in ("normal", "uniform")}
    source = {
        "normal": torch.randn(total["normal"], generator=gen, device=device),
        "uniform": torch.rand(total["uniform"], generator=gen, device=device),
    }
    used = {"normal": 0, "uniform": 0}
    flat = torch.empty(sum(sizes.values()), device=device)
    at = 0
    for n in names:
        kind, scale, offset = rules[n]
        size = sizes[n]
        out = flat[at:at + size]
        if kind == "const":
            out.fill_(offset)
        else:
            x = source[kind][used[kind]:used[kind] + size]
            used[kind] += size
            torch.add(x * scale, offset, out=out)
        at += size
    host = flat.cpu()
    tree: dict = {"params": {}, "batch_stats": {}}
    at = 0
    for n in names:
        leaf = host[at:at + sizes[n]].view(shape_of[n])
        at += sizes[n]
        node = tree["params" if n in pshapes else "batch_stats"]
        *path, last = n.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    if not sshapes:
        del tree["batch_stats"]
    return tree


def model_shapes(model: torch.nn.Module) -> Tuple[Shapes, Shapes]:
    """({param: shape}, {buffer: shape}) of a module, by state_dict name."""
    params = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return params, {n: tuple(b.shape) for n, b in model.state_dict().items()
                    if n not in params}
