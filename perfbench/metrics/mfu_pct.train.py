"""``mfu_pct.train``: model FLOPs of the train steps of the window over
the window's seconds and the card's bf16 dense peak (989 TFLOP/s on the
H100 SXM data sheet).  The model FLOPs of a step are the reference
family's ``model_flops`` (``reference/<family>.py``, from the
yardstick's counts): recompute is not counted."""


def read(ctx):
    if ctx.peaks is None or ctx.window_s <= 0:
        return None
    flops = ctx.reference.model_flops(ctx.model, int(ctx.mix["batch"]),
                                      int(ctx.mix["seq_len"]))
    return 100.0 * flops * ctx.steps / ctx.window_s / ctx.peaks["bf16"]
