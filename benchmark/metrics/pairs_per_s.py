"""pairs_per_s: pairs whose transforms reached the host in the window, over
the window's seconds (the host clock, first call's start to last call's
end)."""


def read(run):
    w = run.window
    return sum(w.units) / w.seconds if w.seconds > 0 else None
