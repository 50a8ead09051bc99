"""setup_s [s]: from the run's process start to the window's start:
imports, inputs made from the seed, the program's scene, the kernels'
builds where the checkout has none, the traffic's own set-up (a
retrieval's observations from the reference) and one warm unit of every
shape (host clock)."""


def read(rec):
    return rec["setup_s"]
