"""Output tokens read on the host in the window (each prefill's and each
decode step's token), over the window's seconds."""


def read(rec):
    return sum(1 for t in rec.tokens if rec.start <= t <= rec.end) \
        / rec.seconds
