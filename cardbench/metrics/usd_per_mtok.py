"""The users' bill per million output tokens of the window. Each request
that started is billed for its execution interval, from its prefill's
start to its last token read (or the window's end), clipped to the
window, at its billed memory (the configuration's ``billing``) times the
rate per GB-second; each request started in the window also pays the
fee per request. Time swapped out to the fair-share lanes is billed."""


def read(rec):
    bill = rec.cell.config["billing"]
    usd = 0.0
    for r in rec.reqs.values():
        if r.t_prefill is None or r.t_prefill > rec.end:
            continue
        stop = rec.end if r.live.completion_ms is None else r.t_last
        seconds = max(0.0, min(stop, rec.end) - max(r.t_prefill, rec.start))
        usd += seconds * rec.billed_gb * bill["usd_per_gb_s"]
        if r.t_prefill >= rec.start:
            usd += bill["usd_per_request"]
    tokens = sum(1 for t in rec.tokens if rec.start <= t <= rec.end)
    return usd / tokens * 1e6 if tokens else None
