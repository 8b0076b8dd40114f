"""Host milliseconds a frame inside the window's ``add_frames`` calls (the
harness's spans, host clock): the chunks read nothing from the device, so
this is the host's cost of enqueueing the steps."""


def read(ctx):
    spans = ctx.spans.get("add_frames")
    if not spans:
        return None
    return (sum(t1 - t0 for t0, t1, _ in spans) * 1e3
            / sum(n for _, _, n in spans))
