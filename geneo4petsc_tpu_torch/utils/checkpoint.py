"""Setup-product checkpointing.

The reference has no resume path (SURVEY.md §5.4); its closest artifact
is binary state dumps via PetscViewer.  GenEO setup (eigensolves and
factorizations) dominates the cost of a solve, so the finished
preconditioner can be saved and loaded: the generic
``GenEOPreconditioner`` (``save_pc`` / ``load_pc``) and the structured
setup products ``StructuredGenEO`` and ``ElasticGenEO``
(``save_setup_tree`` / ``load_setup_tree``), keyed by a configuration
fingerprint.

The file is one ``torch.save`` of a dict of plain values: the
preconditioner's dataclass tree as nested dicts naming each class and
its non-tensor fields, and a flat dict of its tensors, saved from the
host.  No live object is pickled; loading (``weights_only``) rebuilds
the tree from classes of this package only, with every tensor on the
device the caller names.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json

import numpy as np
import torch

_PACKAGE = __name__.split(".")[0]
_FORMAT = 1


def config_fingerprint(**kwargs) -> str:
    """Stable hash of a solve configuration (for cache file naming)."""
    blob = json.dumps(kwargs, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _encode(obj, tensors: dict):
    if isinstance(obj, torch.Tensor):
        key = str(len(tensors))
        tensors[key] = obj.detach().cpu()
        return {"tensor": key}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = type(obj)
        return {"class": f"{cls.__module__}:{cls.__qualname__}",
                "fields": {f.name: _encode(getattr(obj, f.name), tensors)
                           for f in dataclasses.fields(obj)}}
    if isinstance(obj, (tuple, list)):
        return {"tuple" if isinstance(obj, tuple) else "list":
                [_encode(v, tensors) for v in obj]}
    if isinstance(obj, torch.dtype):
        return {"dtype": str(obj).removeprefix("torch.")}
    if isinstance(obj, np.generic):
        obj = obj.item()
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"value": obj}
    raise TypeError(f"checkpoint: cannot save a {type(obj).__name__}")


def _class(path: str):
    module, qualname = path.split(":")
    if module != _PACKAGE and not module.startswith(_PACKAGE + "."):
        raise ValueError(f"checkpoint: class {path} is not part of "
                         f"{_PACKAGE}")
    cls = importlib.import_module(module)
    for part in qualname.split("."):
        cls = getattr(cls, part)
    if not dataclasses.is_dataclass(cls):
        raise ValueError(f"checkpoint: {path} is not a dataclass")
    return cls


def _decode(node: dict, tensors: dict):
    if "tensor" in node:
        return tensors[node["tensor"]]
    if "class" in node:
        return _class(node["class"])(**{
            k: _decode(v, tensors) for k, v in node["fields"].items()})
    if "tuple" in node:
        return tuple(_decode(v, tensors) for v in node["tuple"])
    if "list" in node:
        return [_decode(v, tensors) for v in node["list"]]
    if "dtype" in node:
        return getattr(torch, node["dtype"])
    return node["value"]


def save_setup_tree(path: str, pc) -> None:
    """Save a setup product (a dataclass tree of tensors and plain
    values) to ``path``."""
    import os

    tensors = {}
    tree = _encode(pc, tensors)
    # written whole, then renamed: a reader never sees a partial file
    torch.save({"format": _FORMAT, "tree": tree, "tensors": tensors},
               path + ".part")
    os.replace(path + ".part", path)


def load_setup_tree(path: str, device="cuda"):
    """Load a setup product saved by ``save_setup_tree`` (or ``save_pc``)
    with every tensor on ``device``."""
    data = torch.load(path, map_location=torch.device(device),
                      weights_only=True)
    if data.get("format") != _FORMAT:
        raise ValueError(f"checkpoint {path}: unknown format "
                         f"{data.get('format')}")
    return _decode(data["tree"], data["tensors"])


def save_pc(path: str, pc) -> None:
    """Save a generic ``GenEOPreconditioner`` (operator blocks, level-1
    factors, Z, the coarse factorization, the initial guess)."""
    from ..precond.geneo import GenEOPreconditioner

    if not isinstance(pc, GenEOPreconditioner):
        raise TypeError(f"save_pc: not a GenEOPreconditioner: "
                        f"{type(pc).__name__}")
    save_setup_tree(path, pc)


def load_pc(path: str, device="cuda"):
    """Load a ``GenEOPreconditioner`` saved by ``save_pc`` onto
    ``device``."""
    from ..precond.geneo import GenEOPreconditioner

    pc = load_setup_tree(path, device)
    if not isinstance(pc, GenEOPreconditioner):
        raise TypeError(f"load_pc: {path} holds a {type(pc).__name__}")
    return pc


def setup_with_checkpoint(setup_fn, grid, dom_grid, overlap, geneo, dtype,
                          timers, checkpoint_dir, device, ranks=None,
                          bt_budget_bytes=None):
    """Run ``setup_fn()`` -> (pc, stats), or load its product from
    ``checkpoint_dir`` (None: always run it).

    The key is a fingerprint of the configuration, including a hash of
    the coefficient fields; a warm hit skips the eigensolves and E
    entirely and rebuilds the per-domain coarse dimensions from the
    saved column ids (the other statistics read zero, as in the JAX
    package).  A cold run saves its product for the next one.

    ``ranks`` (parallel.multiproc.Ranks): a multi-rank run, whose ranks
    all run the same replicated setup.  They take a hit only if every
    rank sees the file; on a miss rank 0 alone writes it, and no rank
    returns before it is in place.

    ``bt_budget_bytes`` (set: part of the key): the structured setup's
    block-tridiagonal budget, which picks its local solvers."""
    import os

    from ..precond.geneo import GenEOStats

    if not checkpoint_dir:
        return setup_fn()
    h = hashlib.sha256()
    if hasattr(grid, "edge_off"):                 # StructuredGrid
        for a in range(3):
            h.update(np.ascontiguousarray(grid.edge_off(a)).tobytes())
        h.update(np.ascontiguousarray(grid.diag()).tobytes())
        kind = "structured"
    else:                                         # ElasticGrid
        h.update(np.ascontiguousarray(grid.e_cell).tobytes())
        h.update(np.asarray([grid.nu, grid.spring]).tobytes())
        kind = "elastic"
    fp = config_fingerprint(
        kind=kind, field_hash=h.hexdigest(),
        shape=grid.shape, dom_grid=tuple(dom_grid), overlap=overlap,
        lvl1=geneo.lvl1, lvl2=geneo.lvl2, tau=geneo.tau,
        gamma=geneo.gamma, optim=geneo.optim, cst=geneo.cst,
        cut=geneo.cut, dtype=str(dtype),
        **({} if bt_budget_bytes is None
           else {"bt_budget_bytes": float(bt_budget_bytes)}))
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, f"{kind}_{fp}.pt")
    hit = os.path.exists(path)
    if ranks is not None:
        import torch.distributed as dist
        flag = torch.tensor([int(hit)], device=ranks.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=ranks.group)
        hit = bool(flag.item())
    if hit:
        pc = load_setup_tree(path, device)
        n_dom = int(np.prod(dom_grid))
        stats = GenEOStats(
            estim_dim_e=np.zeros(n_dom, np.int64),
            real_dim_e=np.zeros(n_dom, np.int64),
            nicolaides=np.zeros(n_dom, np.int64),
            tau_loc=np.full(n_dom, -1.0), gamma_loc=np.full(n_dom, -1.0))
        if pc.colids is not None:
            stats.real_dim_e = (pc.colids < pc.dim_e).sum(1).cpu().numpy() \
                .astype(np.int64)
        timers.add("checkpoint_hit", 1.0)
        return pc, stats
    pc, stats = setup_fn()
    if ranks is None or ranks.rank == 0:
        save_setup_tree(path, pc)
    if ranks is not None:
        import torch.distributed as dist
        dist.barrier(group=ranks.group)
    return pc, stats
