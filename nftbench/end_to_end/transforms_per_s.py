"""Transforms completed in the window over the time from its start to the
last call's synchronize (every call started is finished and counted)."""


def read(w):
    return w.calls * w.batch / w.seconds
