"""What the span metrics read: the program's own spans and stamps from a
traced run's recorded slices (``harness/recorded.py``), one function a
quantity, beside ``readers.py``'s.  ``rec["ranks"][0]["recorded"]`` holds
``stamped`` (slice c) and ``profiled`` (slice d), each a
``recorded.summary``; a reader that finds nothing there (no recorded
slices, a program without the recorder, a span the cell's plane never
stamps) returns ``None``.
"""
from .recorded import WAITS


def _slice(rec, name: str):
    ranks = rec.get("ranks") or []
    got = (ranks[0].get("recorded") or {}).get(name) if ranks else None
    return got or None


def host_busy(rec):
    """Host ms a round inside the trainer's ``run`` call, less its waits
    for the card (``chunk.wait``, ``round.wait``), in the stamped slice."""
    c = _slice(rec, "stamped")
    if c is None or not c["rounds"] or "run" not in c["span_ns"]:
        return None
    busy = c["span_ns"]["run"] - sum(c["span_ns"].get(w, 0) for w in WAITS)
    return busy / c["rounds"] / 1e6


def idle_on_host(rec):
    """The share of the profiled recorded slice in which no kernel ran
    and the host was inside a program span other than a wait."""
    d = _slice(rec, "profiled")
    idle = d and d.get("idle")
    if not idle or not idle["window_s"]:
        return None
    return 100.0 * idle["on_host_s"] / idle["window_s"]


def device_span_ms(name: str):
    """A reader of the device span ``name``: its stamped ns summed over a
    round (every interval of it), the mean over the stamped slice's
    rounds, in ms."""
    def read(rec):
        c = _slice(rec, "stamped")
        if c is None or name not in c["device_ns"] or not c["device_rounds"]:
            return None
        return c["device_ns"][name] / c["device_rounds"] / 1e6
    return read
