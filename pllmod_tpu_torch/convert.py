"""State carried across: a Partition, or a whole TreeInfo, built from
plain numpy arrays.

The field names are those of ``pllmod_tpu.ops.partition.Partition``, so a
caller that holds a JAX partition passes ``np.asarray`` of each of its
array fields plus its static fields, and both packages then evaluate the
same model on the same data (the tests feed both this way).
:func:`treeinfo_from_state` does the same for a ``TreeInfo``: its tree,
partitions, linkage, lengths, scalers and optimization masks.
"""

from __future__ import annotations

import numpy as np
import torch

from pllmod_tpu_torch.common import resolve_device
from pllmod_tpu_torch.ops.partition import Partition

ARRAY_FIELDS = ("tip_states", "code_clv", "pattern_weights", "inv_indicator",
                "subst_rates", "freqs", "rate_cats", "rate_weights",
                "prop_invar", "alpha", "param_indices")
EIGEN_FIELDS = ("eigen_lam", "eigen_V", "eigen_Vinv")
META_FIELDS = ("n_tips", "states", "n_patterns", "gamma_mode", "reversible")
_INT_FIELDS = {"tip_states": torch.int32, "param_indices": torch.int64}


def partition_from_arrays(arrays: dict[str, np.ndarray], meta: dict,
                          device="cuda") -> Partition:
    """Partition on ``device`` from ``arrays`` (every name of
    :data:`ARRAY_FIELDS`, optionally the three of :data:`EIGEN_FIELDS`)
    and ``meta`` (the names of :data:`META_FIELDS`; ``gamma_mode`` and
    ``reversible`` may be left out). Float fields keep the dtype of
    ``arrays["freqs"]``."""
    dev = resolve_device(device)
    np_dtype = np.asarray(arrays["freqs"]).dtype
    dtype = torch.from_numpy(np.zeros(0, np_dtype)).dtype
    kw = {}
    for name in ARRAY_FIELDS + EIGEN_FIELDS:
        if name not in arrays or arrays[name] is None:
            if name in EIGEN_FIELDS:
                continue
            raise KeyError(f"missing partition array {name!r}")
        kw[name] = torch.as_tensor(np.array(arrays[name]),
                                   dtype=_INT_FIELDS.get(name, dtype),
                                   device=dev)
    for name in META_FIELDS:
        if name in meta:
            kw[name] = meta[name]
    return Partition(**kw)


def treeinfo_from_state(state: dict, device="cuda"):
    """The port's ``TreeInfo`` from a TreeInfo's state as numpy (the
    attributes of ``pllmod_tpu.tree.treeinfo.TreeInfo`` of the same
    names), on ``device``:

    - ``tree``: the tree's arrays, a dict of ``n_tips``, ``labels``,
      ``edge_nodes``, ``lengths`` and ``n_nodes`` (edge ids kept, so
      that per-edge lengths and ``brlens`` keep their meaning; a Newick
      string would number the edges as its parser does);
    - ``partitions``: per partition a dict of ``arrays`` and ``meta``
      for :func:`partition_from_arrays`, or None (a remote partition);
    - ``brlen_linkage``; ``brlens`` ([n_parts, n_edges] or None);
      ``brlen_scalers``; ``params_to_optimize``.
    """
    from pllmod_tpu_torch.tree.topology import Tree
    from pllmod_tpu_torch.tree.treeinfo import TreeInfo
    spec = state["tree"]
    tree = Tree(spec["n_tips"], spec["labels"], np.array(spec["edge_nodes"]),
                np.array(spec["lengths"]), spec["n_nodes"])
    parts = [None if p is None else
             partition_from_arrays(p["arrays"], p["meta"], device)
             for p in state["partitions"]]
    ti = TreeInfo(tree, parts, brlen_linkage=state["brlen_linkage"],
                  params_to_optimize=list(state["params_to_optimize"]))
    if state.get("brlens") is not None:
        ti.brlens = np.array(state["brlens"], np.float64)
    ti.brlen_scalers = np.array(state["brlen_scalers"], np.float64)
    return ti
