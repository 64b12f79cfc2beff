"""Small host utilities (reference tools/common.py; impx/tools/common.py)."""
from __future__ import annotations

import json

import torch


def save_args(args, save_path):
    with open(save_path, "w") as f:
        json.dump({k: str(v) for k, v in vars(args).items()}, f, indent=2)


def load_args(args, save_path):
    with open(save_path) as f:
        args.__dict__.update(json.load(f))
    return args


def model_size(model: torch.nn.Module) -> int:
    """Total parameter count of a module (reference common.py `model_size`).
    The port's batch-norm statistics are parameters, as they are leaves of
    impx's params, so this equals impx's count of the same matcher."""
    return sum(p.numel() for p in model.parameters())


def map_tensor(input_, func):
    """func applied to every leaf of nested dicts, lists and tuples (torch
    tensors, arrays or anything else); strings and bytes pass through."""
    if isinstance(input_, (str, bytes)):
        return input_
    if isinstance(input_, dict):
        return {k: map_tensor(v, func) for k, v in input_.items()}
    if isinstance(input_, (list, tuple)):
        return type(input_)(map_tensor(v, func) for v in input_)
    return func(input_)
