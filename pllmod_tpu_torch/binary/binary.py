"""Block-based binary checkpoint files — counterpart of
``pllmod_tpu.binary.binary`` (``src/binary/pll_binary.c`` +
``binary_io_operations.c``, SURVEY.md §2.7).

The on-disk format is the JAX package's, structure for structure: the
same magic, header, block map and block headers, and the same ``np.save``
payloads under the same names, so a checkpoint written by either package
loads in the other. Tensors are written as numpy arrays (``.detach().
cpu().numpy()``, any device) and come back as tensors on the device the
caller names, in the file's dtype. The format's parts, each the
reference's:

- global header ``{magic, version, n_blocks, max_blocks, access_type,
  map_offset}`` (pll_binary.h:62-69),
- optional random-access block map ``{block_id, offset}[]`` written at
  create time and patched on close (pll_binary.h:72-76),
- per-block header ``{block_id, type, attributes, block_len}``
  (pll_binary.h:85-93),
- block types PARTITION / CLV / TREE / CUSTOM (pll_binary.h:29-33),
- the same routine reads & writes each payload via a direction flag —
  the reference's ``bin_fread|bin_fwrite`` "apply" pattern
  (binary_io_operations.c:33-57) — realized here as symmetric
  pack/unpack pairs over numpy buffers,
- ``LOAD_SKELETON`` loads partition metadata + model parameters without
  materializing CLV-sized arrays (pll_binary.c:204-516 skeleton mode).

Payload arrays are serialized with ``np.save`` (stable, pickle-free).

A loaded partition is the port's :class:`~pllmod_tpu_torch.ops.partition.
Partition`: it rebuilds what the file does not hold — the reversible
model's eigendecomposition (``cache_eigen``, float64 on the host and
cast, as every optimizer of the port caches it before it evaluates) and
the p-inv flag — so that it evaluates to the saved partition's logL bit
for bit when the saved one held its cache (float64 partitions in any
case: both P-matrix routes then round alike).
"""

from __future__ import annotations

import io
import os
import struct

import numpy as np
import torch

from pllmod_tpu_torch.common import (
    BinaryError,
    BINARY_ERROR_BLOCK_MISMATCH,
    BINARY_ERROR_IO,
    BINARY_ERROR_MISSING_BLOCK,
    host_array,
    resolve_device,
)
from pllmod_tpu_torch.parallel.sharding import is_sharded

MAGIC = b"PLLTPUB1"
ACCESS_SEQUENTIAL = 0
ACCESS_RANDOM = 1

BLOCK_PARTITION = 0
BLOCK_CLV = 1
BLOCK_TREE = 2
BLOCK_CUSTOM = 3
BLOCK_REPEATS = 4

_HDR = struct.Struct("<8sIIIIq")          # magic, ver, n, max, access, map_off
_BLK = struct.Struct("<qIIq")             # block_id, type, attributes, len
_MAP = struct.Struct("<qq")               # block_id, offset


def _pack_arrays(named: dict) -> bytes:
    out = io.BytesIO()
    out.write(struct.pack("<I", len(named)))
    for name, arr in named.items():
        nb = name.encode()
        out.write(struct.pack("<I", len(nb)))
        out.write(nb)
        buf = io.BytesIO()
        np.save(buf, host_array(arr), allow_pickle=False)
        data = buf.getvalue()
        out.write(struct.pack("<q", len(data)))
        out.write(data)
    return out.getvalue()


def _unpack_arrays(data: bytes, skip: set[str] | None = None) -> dict:
    inp = io.BytesIO(data)
    (count,) = struct.unpack("<I", inp.read(4))
    out = {}
    for _ in range(count):
        (ln,) = struct.unpack("<I", inp.read(4))
        name = inp.read(ln).decode()
        (dlen,) = struct.unpack("<q", inp.read(8))
        if skip and name in skip:
            inp.seek(dlen, os.SEEK_CUR)
            continue
        out[name] = np.load(io.BytesIO(inp.read(dlen)), allow_pickle=False)
    return out


class BinaryFile:
    """Checkpoint file with the reference's create/open/append API
    (pll_binary.c:49-190)."""

    def __init__(self, fh, access_type: int, max_blocks: int, mode: str):
        self._fh = fh
        self.access_type = access_type
        self.max_blocks = max_blocks
        self.mode = mode
        self.block_map: list[tuple[int, int]] = []
        self.n_blocks = 0

    # -- lifecycle -----------------------------------------------------
    @classmethod
    def create(cls, path: str, max_blocks: int = 128,
               access_type: int = ACCESS_RANDOM) -> "BinaryFile":
        fh = open(path, "w+b")
        self = cls(fh, access_type, max_blocks, "w")
        self._write_header()
        if access_type == ACCESS_RANDOM:
            # reserve map space right after the header
            fh.write(b"\0" * (_MAP.size * max_blocks))
        return self

    @classmethod
    def open(cls, path: str) -> "BinaryFile":
        fh = open(path, "rb")
        magic, ver, n, mx, access, map_off = _HDR.unpack(
            fh.read(_HDR.size))
        if magic != MAGIC:
            raise BinaryError(BINARY_ERROR_IO, f"bad magic in {path}")
        self = cls(fh, access, mx, "r")
        self.n_blocks = n
        if access == ACCESS_RANDOM:
            fh.seek(map_off)
            for _ in range(n):
                self.block_map.append(_MAP.unpack(fh.read(_MAP.size)))
            self._data_start = map_off + _MAP.size * mx
        return self

    @classmethod
    def open_append(cls, path: str) -> "BinaryFile":
        fh = open(path, "r+b")
        magic, ver, n, mx, access, map_off = _HDR.unpack(fh.read(_HDR.size))
        if magic != MAGIC:
            raise BinaryError(BINARY_ERROR_IO, f"bad magic in {path}")
        self = cls(fh, access, mx, "a")
        self.n_blocks = n
        if access == ACCESS_RANDOM:
            fh.seek(map_off)
            for _ in range(n):
                self.block_map.append(_MAP.unpack(fh.read(_MAP.size)))
        fh.seek(0, os.SEEK_END)
        return self

    def close(self):
        if self.mode in ("w", "a"):
            self._write_header()
            if self.access_type == ACCESS_RANDOM:
                self._fh.seek(_HDR.size)
                for bid, off in self.block_map[:self.max_blocks]:
                    self._fh.write(_MAP.pack(bid, off))
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _write_header(self):
        self._fh.seek(0)
        self._fh.write(_HDR.pack(MAGIC, 1, self.n_blocks, self.max_blocks,
                                 self.access_type, _HDR.size))

    # -- low-level block IO (binary_update_header analog) --------------
    def _dump_block(self, block_id: int, btype: int, payload: bytes,
                    attributes: int = 0):
        if self.mode not in ("w", "a"):
            raise BinaryError(BINARY_ERROR_IO, "file not writable")
        self._fh.seek(0, os.SEEK_END)
        offset = self._fh.tell()
        self._fh.write(_BLK.pack(block_id, btype, attributes, len(payload)))
        self._fh.write(payload)
        self.block_map.append((block_id, offset))
        self.n_blocks += 1

    def _load_block(self, block_id: int, expect_type: int | None = None):
        if self.access_type == ACCESS_RANDOM and self.mode == "r":
            off = next((o for b, o in self.block_map if b == block_id), None)
            if off is None:
                raise BinaryError(BINARY_ERROR_MISSING_BLOCK,
                                  f"block {block_id} not in map")
            self._fh.seek(off)
        bid, btype, attrs, ln = _BLK.unpack(self._fh.read(_BLK.size))
        if self.access_type == ACCESS_RANDOM and bid != block_id:
            raise BinaryError(BINARY_ERROR_BLOCK_MISMATCH,
                              f"wanted block {block_id}, found {bid}")
        if expect_type is not None and btype != expect_type:
            raise BinaryError(BINARY_ERROR_BLOCK_MISMATCH,
                              f"block {bid} has type {btype}")
        return bid, btype, attrs, self._fh.read(ln)

    def seek_first_block(self):
        """Sequential access: position at the first block."""
        start = _HDR.size
        if self.access_type == ACCESS_RANDOM:
            start += _MAP.size * self.max_blocks
        self._fh.seek(start)

    # -- partition dump/load (pll_binary.c:204-516) --------------------
    def dump_partition(self, block_id: int, partition,
                       with_tips: bool = True):
        named = {
            "meta": np.array([partition.n_tips, partition.states,
                              partition.n_patterns, partition.gamma_mode],
                             np.int64),
            "subst_rates": partition.subst_rates,
            "freqs": partition.freqs,
            "rate_cats": partition.rate_cats,
            "rate_weights": partition.rate_weights,
            "prop_invar": partition.prop_invar,
            "alpha": partition.alpha,
            "param_indices": partition.param_indices,
            "pattern_weights": partition.pattern_weights,
        }
        if with_tips:
            named["tip_states"] = partition.tip_states
            named["code_clv"] = partition.code_clv
            named["inv_indicator"] = partition.inv_indicator
        self._dump_block(block_id, BLOCK_PARTITION, _pack_arrays(named),
                         attributes=int(with_tips))

    def load_partition(self, block_id: int, skeleton: bool = False,
                       device="cuda"):
        """Load a partition onto ``device``. ``skeleton=True`` skips the
        big per-site arrays (reference PLLMOD_BIN_ATTRIB_PARTITION_LOAD_
        SKELETON, pll_binary.c:204-516) and returns a Partition *shell*:
        model parameters populated, per-site arrays zero-width. Re-attach
        site data from a live partition with :func:`attach_skeleton`."""
        from pllmod_tpu_torch.convert import partition_from_arrays
        dev = resolve_device(device)
        _, _, attrs, data = self._load_block(block_id, BLOCK_PARTITION)
        skip = ({"tip_states", "code_clv", "inv_indicator",
                 "pattern_weights"} if skeleton else None)
        named = _unpack_arrays(data, skip)
        meta = named.pop("meta")
        n_tips, states = int(meta[0]), int(meta[1])
        if skeleton:
            dtype = named["freqs"].dtype
            named.update(tip_states=np.zeros((n_tips, 0), np.int32),
                         code_clv=np.ones((1, states), dtype),
                         pattern_weights=np.zeros((0,), dtype),
                         inv_indicator=np.zeros((0, states), dtype))
            n_patterns = 0
        elif not attrs:
            raise BinaryError(BINARY_ERROR_MISSING_BLOCK,
                              "partition dumped without tip data")
        else:
            n_patterns = int(meta[2])
        part = partition_from_arrays(
            named, dict(n_tips=n_tips, states=states, n_patterns=n_patterns,
                        gamma_mode=int(meta[3])), dev)
        return part.cache_eigen()

    # ------------------------------------------------------------------
    # -- CLV dump/load (pll_binary.c:517-884) --------------------------
    def dump_clv(self, block_id: int, clv, scaler=None):
        named = {"clv": clv}
        if scaler is not None:
            named["scaler"] = scaler
        self._dump_block(block_id, BLOCK_CLV, _pack_arrays(named))

    def load_clv(self, block_id: int, device="cuda"):
        """(clv, scaler or None) as tensors on ``device``."""
        dev = resolve_device(device)
        _, _, _, data = self._load_block(block_id, BLOCK_CLV)
        named = _unpack_arrays(data)
        scaler = named.get("scaler")
        return (torch.as_tensor(named["clv"], device=dev),
                None if scaler is None else torch.as_tensor(scaler,
                                                            device=dev))

    # -- tree dump/load (pll_binary.c:885-1123) ------------------------
    def dump_tree(self, block_id: int, tree):
        labels = "\x00".join(tree.labels).encode()
        named = {
            "meta": np.array([tree.n_tips, tree.n_nodes], np.int64),
            "labels": np.frombuffer(labels, np.uint8),
            "edge_nodes": tree.edge_nodes,
            "lengths": tree.lengths,
        }
        self._dump_block(block_id, BLOCK_TREE, _pack_arrays(named))

    def load_tree(self, block_id: int):
        from pllmod_tpu_torch.tree.topology import Tree
        _, _, _, data = self._load_block(block_id, BLOCK_TREE)
        named = _unpack_arrays(data)
        labels = bytes(named["labels"]).decode().split("\x00")
        meta = named["meta"]
        return Tree(int(meta[0]), labels, named["edge_nodes"],
                    named["lengths"], n_nodes=int(meta[1]))

    # -- site-repeats dump/load (pll_binary.c:517-884 REPEATS path) ----
    def dump_repeats(self, block_id: int, site_id: dict, id_site: dict):
        """REPEATS block: per-inner-slot ``site_id`` / ``id_site`` arrays
        (``ops.repeats.compute_repeats`` output, host arrays — the
        reference round-trips exactly these identity arrays alongside the
        CLVs)."""
        named = {}
        for s, arr in site_id.items():
            named[f"sid{int(s)}"] = host_array(arr).astype(np.int32)
        for s, arr in id_site.items():
            named[f"ids{int(s)}"] = host_array(arr).astype(np.int64)
        self._dump_block(block_id, BLOCK_REPEATS, _pack_arrays(named))

    def load_repeats(self, block_id: int):
        """Returns (site_id, id_site) dicts of host arrays keyed by inner
        slot."""
        _, _, _, data = self._load_block(block_id, BLOCK_REPEATS)
        site_id, id_site = {}, {}
        for k, v in _unpack_arrays(data).items():
            (site_id if k.startswith("sid") else id_site)[int(k[3:])] = v
        return site_id, id_site

    # -- custom blobs (pll_binary.c:1125-1270) -------------------------
    def dump_custom(self, block_id: int, blob: bytes):
        self._dump_block(block_id, BLOCK_CUSTOM, blob)

    def load_custom(self, block_id: int) -> bytes:
        _, _, _, data = self._load_block(block_id, BLOCK_CUSTOM)
        return data

    def get_block_map(self):
        """pllmod_binary_get_map analog."""
        return list(self.block_map)


def attach_skeleton(skeleton, source):
    """Re-attach per-site data to a skeleton-loaded partition shell.

    The reference's LOAD_SKELETON mode allocates pointer shells that the
    caller later points at live buffers (pll_binary.c:204-516); here the
    site arrays (tip states, code table, weights, invariant indicator) are
    copied from ``source`` — typically the partition rebuilt from the MSA —
    onto the skeleton's device and float dtype, while the *checkpointed*
    model parameters win.
    """
    if (skeleton.n_tips != source.n_tips
            or skeleton.states != source.states):
        raise BinaryError(BINARY_ERROR_BLOCK_MISMATCH,
                          "skeleton/source dimension mismatch")
    dev, dt = skeleton.device, skeleton.dtype
    return skeleton.replace(
        tip_states=source.tip_states.to(dev),
        code_clv=source.code_clv.to(dev, dt),
        pattern_weights=source.pattern_weights.to(dev, dt),
        inv_indicator=source.inv_indicator.to(dev, dt),
        n_patterns=source.n_patterns)


# ---------------------------------------------------------------------------
# TreeInfo-level checkpointing (the RAxML-NG checkpoint composition:
# model state of every partition + topology/branch lengths + search
# bookkeeping, built on the reference's block primitives).
# ---------------------------------------------------------------------------
def save_treeinfo(path: str, treeinfo, extra: bytes = b""):
    """Checkpoint a TreeInfo: one PARTITION block per local partition
    (remote ``None`` slots recorded and skipped), one TREE block, and a
    CUSTOM block holding linkage mode / scalers / brlens / param masks
    (the reference's downstream checkpoint composition over
    pll_binary.c:204-1270). ``extra`` rides along for caller state
    (e.g. an optimizer's bookkeeping). A sharded partition is written
    whole (its shards gathered), so the file loads with or without a
    mesh."""
    import json

    meta = {
        "n_partitions": treeinfo.n_partitions,
        "local": [i for i, p in enumerate(treeinfo.partitions)
                  if p is not None],
        "brlen_linkage": int(treeinfo.brlen_linkage),
        "brlen_scalers": np.asarray(treeinfo.brlen_scalers).tolist(),
        "params_to_optimize": [int(m) for m in treeinfo.params_to_optimize],
        "brlens": (np.asarray(treeinfo.brlens).tolist()
                   if treeinfo.brlens is not None else None),
        "extra_len": len(extra),
    }
    blob = json.dumps(meta).encode() + b"\0" + extra
    with BinaryFile.create(path,
                           max_blocks=treeinfo.n_partitions + 2) as f:
        f.dump_custom(0, blob)
        f.dump_tree(1, treeinfo.tree)
        for i in meta["local"]:
            p = treeinfo.partitions[i]
            f.dump_partition(2 + i, p.gather() if is_sharded(p) else p)


def load_treeinfo(path: str, device="cuda"):
    """Restore a TreeInfo checkpoint with its partitions on ``device``.
    Returns (treeinfo, extra_bytes); remote partitions come back as
    ``None`` slots (re-init them with the owning rank's data, mirroring
    pllmod_treeinfo_init_partition)."""
    import json
    from pllmod_tpu_torch.tree.treeinfo import TreeInfo

    dev = resolve_device(device)
    with BinaryFile.open(path) as f:
        blob = f.load_custom(0)
        head, _, extra = blob.partition(b"\0")
        meta = json.loads(head.decode())
        tree = f.load_tree(1)
        partitions = [None] * meta["n_partitions"]
        for i in meta["local"]:
            partitions[i] = f.load_partition(2 + i, device=dev)
    ti = TreeInfo(tree, partitions,
                  brlen_linkage=meta["brlen_linkage"],
                  params_to_optimize=meta["params_to_optimize"])
    ti.brlen_scalers = np.asarray(meta["brlen_scalers"])
    if meta["brlens"] is not None and ti.brlens is not None:
        ti.brlens = np.asarray(meta["brlens"])
    return ti, extra[:meta["extra_len"]]
