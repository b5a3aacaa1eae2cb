"""Percent of the window in the CLI's own code: the ``command:*`` spans less
the part of them that other spans cover (``cli.py``, ``commands/``)."""

from bench_port.harness.tracing import union


def read(run):
    cmds = [s for s in run.spans if s.name.startswith("command:")]
    if not cmds:
        return None
    others = [s for s in run.spans if not s.name.startswith("command:")]
    own = 0.0
    for c in cmds:
        inside = [(max(s.start, c.start), min(s.end, c.end)) for s in others
                  if s.end > c.start and s.start < c.end]
        own += (c.end - c.start) - sum(e - s for s, e in union(inside))
    return 100.0 * own / run.window_s
