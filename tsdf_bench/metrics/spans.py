"""The program's own spans and counters over a run's traced slice, and
the arithmetic on them (not a metric: the readers of the span metrics
use it).

``chad_tsdf_tpu_torch.utils.timing.profiled()`` holds the spans that
closed while the slice's profiler ran, as (name, start s, end s) on the
host clock, and the growth of the program's counters over them.  A run
without a traced slice, or a program without spans, gives None."""


def profiled(rec):
    """The program's spans and counter growth over ``rec``'s traced slice,
    or None."""
    if not rec.trace:
        return None
    try:
        from chad_tsdf_tpu_torch.utils import timing
    except ImportError:
        return None
    get = getattr(timing, "profiled", None)
    return get() if get is not None else None


def table(spans) -> dict:
    """{name: {"count", "total_s", "self_s"}} of spans (name, start,
    end) taken on one thread, so two spans are nested or disjoint.  A
    span's self time is its length less the part its child spans cover
    (children of one span are disjoint, so their lengths add)."""
    out: dict = {}
    stack: list = []                  # [name, start, end, child seconds]

    def close(frame):
        name, a, b, child = frame
        row = out.setdefault(name, {"count": 0, "total_s": 0.0,
                                    "self_s": 0.0})
        row["count"] += 1
        row["total_s"] += b - a
        row["self_s"] += b - a - child

    for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        while stack and stack[-1][2] <= a:
            close(stack.pop())
        if stack:
            stack[-1][3] += b - a
        stack.append([name, a, b, 0.0])
    while stack:
        close(stack.pop())
    return out


def mean_ms(rec, name: str, per: str, key: str = "total_s"):
    """``key`` of span ``name`` summed over the slice, over the number of
    ``per`` spans, in milliseconds; None where either span is absent."""
    p = profiled(rec)
    if p is None:
        return None
    t = table(p["spans"])
    if name not in t or per not in t:
        return None
    return t[name][key] / t[per]["count"] * 1e3


def innermost(spans, s0: float, s1: float) -> list:
    """[s0, s1] cut into disjoint (start, end, name) pieces, each named by
    the innermost span open there, ``"outside"`` where none is."""
    pieces: list = []
    stack: list = []
    t = s0

    def upto(end, name):
        nonlocal t
        a, b = max(t, s0), min(end, s1)
        if b > a:
            pieces.append((a, b, name))
        t = max(t, end)

    for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        while stack and stack[-1][2] <= a:
            upto(stack[-1][2], stack[-1][0])
            stack.pop()
        upto(a, stack[-1][0] if stack else "outside")
        stack.append((name, a, b))
    while stack:
        upto(stack[-1][2], stack[-1][0])
        stack.pop()
    upto(s1, "outside")
    return pieces


def idle_by_span(busy, spans, s0: float, s1: float) -> dict:
    """The idle time of [s0, s1] (what the sorted, disjoint ``busy``
    intervals leave) by the innermost span open on the host then."""
    out: dict = {}
    idle, prev = [], s0
    for a, b in list(busy) + [[s1, s1]]:
        if a > prev:
            idle.append((prev, min(a, s1)))
        prev = max(prev, b)
    i = 0
    for a, b, name in innermost(spans, s0, s1):
        while i < len(idle) and idle[i][1] <= a:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < b:
            over = min(b, idle[j][1]) - max(a, idle[j][0])
            if over > 0:
                out[name] = out.get(name, 0.0) + over
            j += 1
    return out
