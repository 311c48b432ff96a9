"""gs.graph_captures: CUDA graphs the trainer captured inside the window
(segment steps and batched renders, ``GSTrainer.graph_builds``); every
capture belongs in set-up, so 0 is expected."""


def read(ctx):
    if ctx.get("kind") != "gs":
        return None
    return ctx["window_captures"]
