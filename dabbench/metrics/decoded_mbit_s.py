"""decoded_mbit_s (Mbit/s): the data bits (frames x framebits) of every
call that returned its output to the host in the window, over the
window's whole length (start to the last call's return)."""


def read(run):
    bits = sum(r.call.bits for r in run.records() if r.error is None)
    return bits / (run.t_end - run.t_start) / 1e6 if bits else None
