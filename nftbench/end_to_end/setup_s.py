"""Process start to the window's start: imports, the CUDA context, the
entry's tables and kernels (built in a checkout's first run), the inputs
and the warm-up."""


def read(w):
    return w.setup_s
