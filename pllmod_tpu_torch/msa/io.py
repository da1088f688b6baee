"""Alignment file IO: FASTA and (relaxed/interleaved) PHYLIP.

Counterpart of libpll's ``pll_fasta_open/getnext/close`` and
``pll_phylip_load`` (SURVEY.md §2.9 I/O) plus the PHYLIP writer of
``pll_msa.c:1288-1324``.
"""

from __future__ import annotations

import io
import os

from pllmod_tpu_torch.common import MsaError, OPT_ERROR_ALIGN_UNREADABLE
from pllmod_tpu_torch.msa.msa import MSA


def read_fasta(path_or_text: str) -> MSA:
    """Read a FASTA alignment (file path or raw text)."""
    text = _get_text(path_or_text)
    labels, seqs = [], []
    cur = None
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            labels.append(line[1:].split()[0])
            seqs.append([])
            cur = seqs[-1]
        else:
            if cur is None:
                raise MsaError(OPT_ERROR_ALIGN_UNREADABLE,
                               "FASTA: sequence before header")
            cur.append(line)
    if not labels:
        raise MsaError(OPT_ERROR_ALIGN_UNREADABLE, "FASTA: no sequences")
    return MSA(labels, ["".join(s) for s in seqs])


def read_phylip(path_or_text: str, interleaved: bool | None = None) -> MSA:
    """Read relaxed PHYLIP (sequential or interleaved; auto-detected)."""
    text = _get_text(path_or_text)
    lines = [l.rstrip() for l in text.splitlines() if l.strip()]
    if not lines:
        raise MsaError(OPT_ERROR_ALIGN_UNREADABLE, "PHYLIP: empty")
    try:
        n_taxa, n_sites = (int(x) for x in lines[0].split()[:2])
    except (ValueError, IndexError) as e:
        raise MsaError(OPT_ERROR_ALIGN_UNREADABLE,
                       f"PHYLIP: bad header {lines[0]!r}") from e
    body = lines[1:]
    labels: list[str] = []
    seqs: list[list[str]] = []
    # first block: n_taxa lines of "name seq..."
    if len(body) < n_taxa:
        raise MsaError(OPT_ERROR_ALIGN_UNREADABLE, "PHYLIP: truncated")
    for i in range(n_taxa):
        parts = body[i].split()
        labels.append(parts[0])
        seqs.append(["".join(parts[1:])])
    # remaining blocks (interleaved continuation)
    rest = body[n_taxa:]
    idx = 0
    for line in rest:
        parts = line.split()
        # continuation lines may repeat the name or not
        if parts and parts[0] == labels[idx % n_taxa] and len(parts) > 1:
            seq = "".join(parts[1:])
        else:
            seq = "".join(parts)
        seqs[idx % n_taxa].append(seq)
        idx += 1
    sequences = ["".join(chunks) for chunks in seqs]
    if any(len(s) != n_sites for s in sequences):
        raise MsaError(OPT_ERROR_ALIGN_UNREADABLE,
                       f"PHYLIP: sequence lengths != {n_sites}")
    return MSA(labels, sequences)


def load_msa(path: str) -> MSA:
    """Auto-detect FASTA vs PHYLIP by first non-blank character."""
    text = _get_text(path)
    first = next((c for c in text if not c.isspace()), "")
    if first == ">":
        return read_fasta(text)
    return read_phylip(text)


def write_fasta(msa: MSA, path: str | None = None, width: int = 70) -> str:
    out = io.StringIO()
    for lb, s in zip(msa.labels, msa.sequences):
        out.write(f">{lb}\n")
        for i in range(0, len(s), width):
            out.write(s[i:i + width] + "\n")
    text = out.getvalue()
    if path:
        with open(path, "w") as fh:
            fh.write(text)
    return text


def write_phylip(msa: MSA, path: str | None = None) -> str:
    """Sequential relaxed PHYLIP (pllmod_msa_save_phylip,
    pll_msa.c:1288-1324)."""
    out = io.StringIO()
    out.write(f"{msa.n_taxa} {msa.n_sites}\n")
    pad = max(len(l) for l in msa.labels) + 2
    for lb, s in zip(msa.labels, msa.sequences):
        out.write(lb.ljust(pad) + s + "\n")
    text = out.getvalue()
    if path:
        with open(path, "w") as fh:
            fh.write(text)
    return text


def _get_text(path_or_text: str) -> str:
    if "\n" not in path_or_text and os.path.exists(path_or_text):
        with open(path_or_text) as fh:
            return fh.read()
    return path_or_text
