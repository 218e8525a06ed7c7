"""Peak device memory allocated in the window, GiB."""


def read(run):
    peak = run.window.get("peak_bytes")
    return None if not peak else peak / 2 ** 30
