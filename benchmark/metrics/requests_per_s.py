"""requests_per_s: requests completed in the window over the window's
wall time (host clock), every request of the window counted."""


def read(r):
    if not r.window_s or r.window_s <= 0:
        return None
    return r.completed / r.window_s
