"""Chain-state and warmup checkpoints (port of
``mcmc_tpu/utils/checkpoint.py``).

Warmup products (tuned step, learned inverse metric, warmed positions,
GRAHMC's friction, ChEES's trajectory) are kept per run signature, so a
re-run of the benchmark runner skips the warmups it already paid for; a
sampling phase keeps its chain state, partial history and generator states
at its convergence checkpoints, so a preempted run resumes where it
stopped, draw for draw.

Format: one ``.npz`` of host arrays per checkpoint, keyed by the tree's
paths, and a JSON sidecar for scalar metadata. Nested dicts, lists, tuples
and NamedTuples of tensors are trees; restored leaves take the dtype and
device of a ``like`` tree's leaves.
"""

import glob
import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _children(tree):
    """(name, child) pairs of a tree node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten_with_names(tree, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} with readable '/'-joined keys ('_root' for a bare leaf)."""
    kids = _children(tree)
    if kids is None:
        return {prefix or "_root": tree}
    out = {}
    for name, child in kids:
        out.update(_flatten_with_names(child, f"{prefix}/{name}" if prefix else name))
    return out


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Write `path` through a temporary file and a rename: a crash leaves
    the old file or the new one, never a truncated one."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
    os.replace(tmp, path)


def save_state_tree(path: str, tree, meta: Optional[Dict] = None) -> None:
    """Save a tree of tensors to `<path>.npz` (host copies) and, with
    `meta`, its JSON to `<path>.json`, each written atomically."""
    _write_npz(path + ".npz", {k: _host(v) for k, v in _flatten_with_names(tree).items()})
    if meta is not None:
        _write_json(path + ".json", meta)


def _rebuild(like, arrays: Dict[str, np.ndarray], prefix: str = ""):
    kids = _children(like)
    if kids is None:
        a = arrays[prefix or "_root"]
        if isinstance(like, torch.Tensor):
            return torch.as_tensor(a).to(dtype=like.dtype, device=like.device)
        return torch.as_tensor(a)
    built = [_rebuild(child, arrays, f"{prefix}/{name}" if prefix else name)
             for name, child in kids]
    if isinstance(like, dict):
        return dict(zip(like.keys(), built))
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*built)
    return type(like)(built)


def load_state_tree(path: str, like=None) -> Tuple[Any, Optional[Dict]]:
    """Load `<path>.npz` (and its JSON, or None). With `like` (a tree of
    the same structure), the arrays are rebuilt into it as tensors of each
    `like` leaf's dtype and device; without, the raw {path: numpy array}
    dict is returned with the dtypes on disk."""
    with np.load(path + ".npz") as z:
        arrays = {k: z[k] for k in z.files}
    meta = None
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    if like is None:
        return arrays, meta
    missing = [n for n in _flatten_with_names(like) if n not in arrays]
    if missing:
        raise ValueError(f"checkpoint {path} missing leaves: {missing}")
    return _rebuild(like, arrays), meta


# ---------------------------------------------------------------------------
# Warmup checkpoints (benchmark runner)
# ---------------------------------------------------------------------------

def warmup_signature(sampler: str, target_name: str, schedule, num_steps, learn_mass,
                     n_chains: int, dim: int, num_warmup: int = 0, backend: str = "") -> str:
    """Filesystem-safe key of one warmup configuration: the runner's resume
    signature plus everything that changes what the warmup produces (the
    shapes, the warmup budget, the stepping backend; the dense metric
    apart from the diagonal one). The JAX package's key, character for
    character."""
    sched = schedule if schedule else "none"
    tail = f"_w{num_warmup}" if num_warmup else ""
    if backend:
        tail += f"_{backend}"
    mass_tag = "dense" if learn_mass == "dense" else int(bool(learn_mass))
    return (f"{sampler}_{target_name}_{sched}_L{num_steps}_"
            f"mass{mass_tag}_c{n_chains}_d{dim}{tail}")


_WARMUP_FLOATS = ("gamma", "steepness", "scale", "trajectory_length")
_WARMUP_INFO = ("gamma", "steepness", "scale", "trajectory_length", "num_steps",
                "halton_offset", "max_steps_cap_hit", "gamma_tuner")


def save_warmup(cache_dir: str, signature: str, step_size: float, inv_mass, position,
                warmup_info: Dict) -> None:
    """Keep one warmup's products under `cache_dir/<signature>`."""
    os.makedirs(cache_dir, exist_ok=True)
    tree = {"position": position}
    if inv_mass is not None:
        tree["inv_mass"] = inv_mass
    meta = {"step_size": float(step_size), "has_inv_mass": inv_mass is not None}
    for k in _WARMUP_FLOATS:
        meta[k] = float(warmup_info[k]) if k in warmup_info else None
    meta["num_steps"] = int(warmup_info["num_steps"]) if "num_steps" in warmup_info else None
    meta["halton_offset"] = (int(warmup_info["halton_offset"])
                             if "halton_offset" in warmup_info else None)
    meta["max_steps_cap_hit"] = (bool(warmup_info["max_steps_cap_hit"])
                                 if "max_steps_cap_hit" in warmup_info else None)
    meta["gamma_tuner"] = warmup_info.get("gamma_tuner")
    save_state_tree(os.path.join(cache_dir, signature), tree, meta)


def load_warmup(cache_dir: str, signature: str, device):
    """A warmup checkpoint as (step_size, inv_mass or None, position, info),
    the tensors on `device` (the run's: it has no default, so that a state
    never lands on the host unasked); None when absent or unreadable (the caller
    re-runs the warmup)."""
    path = os.path.join(cache_dir, signature)
    if not os.path.exists(path + ".npz"):
        return None
    try:
        arrays, meta = load_state_tree(path)
        if meta is None:
            return None
        inv_mass = (torch.as_tensor(arrays["inv_mass"], device=device)
                    if meta["has_inv_mass"] else None)
        info = {k: meta[k] for k in _WARMUP_INFO if meta.get(k) is not None}
        return (meta["step_size"], inv_mass, torch.as_tensor(arrays["position"], device=device),
                info)
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Mid-sampling checkpoints (benchmark runner, sampling phase)
# ---------------------------------------------------------------------------

class SamplingCheckpoint:
    """Chain state, partial history and generator states at the runner's
    convergence checkpoints, so a run preempted mid-sampling resumes from
    its last checkpoint, draw for draw.

    Under ``<cache_dir>/<signature>_sampling/``: ``piece_<i>.npz``, one per
    completed checkpoint batch, written once each (a save writes only the
    new draws); ``state_<draw>.npz`` (the positions, the run generator's
    and the W2 tracker generator's ``get_state()`` bytes, the tempered
    replicas' positions where there are any); and ``meta.json``, which
    names its state file and holds the draw cursor, the batches' stats, the
    convergence trace so far and a config stamp that must match on load.
    The state file is written first, under a name of its own, and meta.json
    replaced atomically last, so a crash at any point leaves a meta.json
    whose state file is whole: state and meta are one atomic pair (the JAX
    package rewrites ``state.npz`` in place first, and a crash between the
    two files pairs a new state with an old meta).

    Resume is draw-exact: every sampler draws its randomness, the fused
    kernels' Philox key words included, from the run's generator at the
    start of each run call, so the generator's state at a batch boundary is
    all a resumed run needs.
    """

    def __init__(self, cache_dir: str, signature: str, config: Dict):
        self.dir = os.path.join(cache_dir, signature + "_sampling")
        self.config = {k: (v if isinstance(v, (str, bool, type(None)))
                           else float(v) if isinstance(v, float) else int(v))
                       for k, v in config.items()}
        self._n_pieces = 0

    def load(self, device):
        """The restored loop state, or None (no checkpoint, another config,
        unreadable). Keys: prev, generator_state, w2_generator_state,
        position, replica_pos, halton_cursor, chees_leapfrogs,
        convergence_trace, piece_samples, piece_stats; the tensors of the
        chains on `device` (the run's, as load_warmup's)."""
        meta_path = os.path.join(self.dir, "meta.json")
        if not os.path.exists(meta_path):
            return None
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            if meta["config"] != self.config:
                return None
            with np.load(os.path.join(self.dir, meta["state_file"])) as z:
                arrays = {k: z[k] for k in z.files}
            pieces = []
            for i in range(meta["n_pieces"]):
                with np.load(os.path.join(self.dir, f"piece_{i}.npz")) as z:
                    pieces.append(torch.as_tensor(z["samples"], device=device))
            self._n_pieces = meta["n_pieces"]
            return {
                "prev": meta["prev"],
                "generator_state": torch.as_tensor(arrays["generator"]),
                "w2_generator_state": torch.as_tensor(arrays["w2_generator"]),
                "position": torch.as_tensor(arrays["position"], device=device),
                "replica_pos": (torch.as_tensor(arrays["replica_pos"], device=device)
                                if "replica_pos" in arrays else None),
                "halton_cursor": meta["halton_cursor"],
                "chees_leapfrogs": meta["chees_leapfrogs"],
                "convergence_trace": meta["convergence_trace"],
                "piece_samples": pieces,
                "piece_stats": meta["piece_stats"],
            }
        except Exception:
            return None

    def save(self, prev, generator_state, w2_generator_state, position, replica_pos,
             halton_cursor, chees_leapfrogs, convergence_trace, piece_samples, piece_stats):
        """Keep the loop state after a completed checkpoint (see the class
        docstring for the order of the writes)."""
        os.makedirs(self.dir, exist_ok=True)
        for i in range(self._n_pieces, len(piece_samples)):
            _write_npz(os.path.join(self.dir, f"piece_{i}.npz"),
                       {"samples": _host(piece_samples[i])})
        self._n_pieces = len(piece_samples)
        state_file = f"state_{int(prev)}.npz"
        arrays = {"position": _host(position), "generator": _host(generator_state),
                  "w2_generator": _host(w2_generator_state)}
        if replica_pos is not None:
            arrays["replica_pos"] = _host(replica_pos)
        _write_npz(os.path.join(self.dir, state_file), arrays)
        _write_json(os.path.join(self.dir, "meta.json"), {
            "config": self.config,
            "state_file": state_file,
            "prev": int(prev),
            "n_pieces": len(piece_samples),
            "halton_cursor": int(halton_cursor),
            "chees_leapfrogs": int(chees_leapfrogs),
            "convergence_trace": convergence_trace,
            "piece_stats": piece_stats,
        })
        for old in glob.glob(os.path.join(self.dir, "state_*.npz")):
            if os.path.basename(old) != state_file:
                os.remove(old)

    def clear(self):
        """Delete the checkpoint once the row is saved: the history is large
        and the runner's resume by signature takes over."""
        shutil.rmtree(self.dir, ignore_errors=True)
