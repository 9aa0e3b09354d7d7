"""Per cent of the prompt slots of the engine's prefill batches that are
padding: read from the ``tokens`` tensor ``ServeEngine.prompt_batch`` built,
against the lengths the traffic drew."""


def read(ctx):
    slots = ctx.counters.get("prompt_slots", 0)
    return 100.0 * ctx.counters["padding_slots"] / slots if slots else None
