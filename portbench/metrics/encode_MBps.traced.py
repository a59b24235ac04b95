"""MB (10^6 bytes) of input that compress took in over the seconds of the
traced window: the encode rate, with the profiler's cost on the host in
it. The untraced rate is no end-to-end metric here: the encoder's main
thread is on the CPU for the whole window, so the rate follows the host's
speed, which moved 10-25 % between runs on the same card."""


def read(t):
    if not t.mb or not t.window_s:
        return None
    return t.mb / t.window_s
