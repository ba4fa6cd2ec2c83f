"""clouds_per_s: clouds of every step completed in the window (the global
batch on several cards), over the window's seconds on rank 0's host
clock."""


def read(run):
    w = run.window
    return sum(w.units) / w.seconds if w.seconds > 0 else None
