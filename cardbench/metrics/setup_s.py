"""Process start to the window's start: imports, the weights, the engine
(its slot caches and captured decode graphs, and the kernels' build where
the checkout has none yet) and the warm-up."""


def read(rec):
    return rec.setup_s
