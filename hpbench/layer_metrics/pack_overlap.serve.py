"""Share of the window's batches whose pack and forward enqueue ended
while the previous batch still ran on the device (the server's
``stats()['overlapped']`` over its ``batches``, across the window), %.
None where the server keeps no such counter."""


def read(run):
    a, b = run.window["open"]["stats"], run.window["close"]["stats"]
    batches = b["batches"] - a["batches"]
    if "overlapped" not in b or batches <= 0:
        return None
    return 100.0 * (b["overlapped"] - a["overlapped"]) / batches
