"""Preemptions (``LiveRequest.preemptions``, the program's own count) per
request whose prefill started in the window."""


def read(rec):
    started = [r for r in rec.reqs.values() if r.t_prefill is not None
               and rec.start <= r.t_prefill <= rec.end]
    if not started:
        return None
    return sum(r.live.preemptions for r in started) / len(started)
