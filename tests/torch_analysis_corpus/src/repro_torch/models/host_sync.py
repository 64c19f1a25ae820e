"""Host syncs inside model code that a captured step runs.  Each raises
"operation not permitted when stream is capturing" under CUDA graph
capture, and costs one host sync per call eagerly."""
import numpy as np
import torch
import torch.nn.functional as F


def read_scalar(x: torch.Tensor):
    return x.sum().item()  # EXPECT: host-sync-in-step


def read_list(logits):
    top = torch.argmax(logits, -1)
    return top.tolist()  # EXPECT: host-sync-in-step


def export(t):
    t = t.detach().cpu()  # EXPECT: host-sync-in-step
    return t.numpy()  # EXPECT: host-sync-in-step


def python_scalars(x: torch.Tensor):
    s = torch.sum(x)
    a = bool(s > 0)  # EXPECT: host-sync-in-step
    b = int(s)  # EXPECT: host-sync-in-step
    c = float(F.relu(s))  # EXPECT: host-sync-in-step
    return a, b, c


def branch(x: torch.Tensor):
    if (x > 0).any():  # EXPECT: host-sync-in-step
        x = x * 2
    while torch.linalg.norm(x) > 1.0:  # EXPECT: host-sync-in-step
        x = x * 0.5
    assert torch.isfinite(x).all()  # EXPECT: host-sync-in-step
    return x if x.max() > 0 else -x  # EXPECT: host-sync-in-step


def data_shaped(x: torch.Tensor, ids: torch.Tensor):
    keep = torch.nonzero(x)  # EXPECT: host-sync-in-step
    vals = torch.masked_select(x, x > 0)  # EXPECT: host-sync-in-step
    uniq = torch.unique(ids)  # EXPECT: host-sync-in-step
    rows = ids.nonzero()  # EXPECT: host-sync-in-step
    where = torch.where(x > 0)  # EXPECT: host-sync-in-step
    mask = x > 0
    picked = x[mask]  # EXPECT: host-sync-in-step
    return keep, vals, uniq, rows, where, picked


def static_ok(x: torch.Tensor, sp, w):
    # shape, dtype, device and numel reads are static; identity checks
    # never read a value; a mask used by a masked op stays on the device
    if x.shape[0] > 1 and x.dtype == torch.bfloat16:
        x = x.float()
    if sp is None or x.numel() == 0 or x.device.type == "cpu":
        return x
    n = int(x.shape[-1])
    mask = x > 0
    y = torch.where(mask, x, torch.zeros_like(x))
    y = y.masked_fill(~mask, 0.0)
    fixed = torch.nonzero_static(x, size=8)
    host = np.arange(n)
    return y, fixed, host.tolist(), host.sum().item(), w.shape[1]
