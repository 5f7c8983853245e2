"""sep_audio_s_per_s: seconds of input audio separated per second of
the window, over every call of the window."""


def read(ctx):
    return ctx.calls * ctx.work_per_call / ctx.window_s
