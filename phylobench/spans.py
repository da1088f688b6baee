"""What the program's own spans recorded in a traced stretch: the
recorder of ``pllmod_tpu_torch.profile``, which holds a span only while
the profiler runs, and a benchmark process runs the profiler over its
traced stretch alone. A program without the recorder reads as nothing
recorded."""

from __future__ import annotations

from pllmod_tpu_torch import profile


def summary(run, kind: str, root: str):
    """The recorder's summary by span name (``profile.summary()``) for a
    run of request kind ``kind``; None where the run is of another kind
    or no ``root`` span was recorded."""
    if run.kind != kind:
        return None
    read = getattr(profile, "summary", None)
    got = read() if read is not None else {}
    return got if got.get(root, {}).get("count") else None


def per_call_ms(run, kind: str, root: str, name: str | None = None,
                less: str | None = None):
    """Mean ms per ``root`` span of the spans ``name`` (by default
    ``root`` itself), less the spans ``less``; None where no ``root``
    span was recorded."""
    got = summary(run, kind, root)
    if got is None:
        return None
    ns = got.get(name or root, {}).get("total_ns", 0)
    if less is not None:
        ns -= got.get(less, {}).get("total_ns", 0)
    return 1e-6 * ns / got[root]["count"]


def roots(name: str) -> list:
    """The recorded root spans named ``name``, in the order entered."""
    spans = getattr(profile, "SPANS", [])
    return [s for s in spans if s.parent < 0 and s.name == name]
