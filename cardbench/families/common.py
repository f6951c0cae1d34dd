"""What the model families share: configs from a configuration file, the
reference's train steps, and the readings a train step's check compares."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping

import torch

def config_from(cls, fields: Mapping):
    """`cls(**fields)`, lists turned into the tuples the dataclass has."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in fields:
            v = fields[f.name]
            kw[f.name] = tuple(v) if isinstance(v, list) else v
    unknown = set(fields) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"unknown config keys {sorted(unknown)}")
    return cls(**kw)


def clipped_grad_norms(model: torch.nn.Module, grad_clip: float
                       ) -> Dict[str, torch.Tensor]:
    """{leaf: norm of the gradient an optimizer step takes}, read from the
    leaves' `.grad` as the step is entered (a missing one counts as zero)
    and scaled as the configuration's clip scales them: by grad_clip over
    the global norm where that reaches grad_clip."""
    norms = {n: torch.zeros((), device=p.device) if p.grad is None
             else p.grad.detach().float().norm()
             for n, p in model.named_parameters()}
    total = torch.sqrt(sum(v * v for v in norms.values()))
    scale = torch.where(total >= grad_clip, grad_clip / total,
                        torch.ones_like(total))
    return {n: v * scale for n, v in norms.items()}


def params_copy(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def change_norms(model: torch.nn.Module, start: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    return {n: (p.detach() - start[n]).norm()
            for n, p in model.named_parameters()}


def run_ref_steps(model: torch.nn.Module, optimizer, loss_of: Callable,
                  batches: List[dict], keys, device, grad_clip: float
                  ) -> dict:
    """The reference's train steps over `batches`, as the port's step runs
    one: zero the gradients, the forward and the losses (`loss_of(tensors)`
    gives the dict of losses), their sum's backward, the clip and AdamW.
    Returns {"losses": [float], "grad": first-step leaf gradient norms,
    "change": leaf change norms after the last step}."""
    start = params_copy(model)
    losses, grad = [], None
    for i, batch in enumerate(batches):
        t = {k: torch.as_tensor(batch[k], device=device) for k in keys}
        model.train()
        optimizer.zero_grad(set_to_none=True)
        total = sum(loss_of(t).values())
        total.backward()
        if i == 0:
            grad = clipped_grad_norms(model, grad_clip)
        optimizer.step()
        losses.append(total.detach())
    change = change_norms(model, start)
    return {"losses": [float(x) for x in losses],
            "grad": {k: float(v) for k, v in grad.items()},
            "change": {k: float(v) for k, v in change.items()}}
