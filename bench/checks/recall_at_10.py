"""Recall@10 of every answered query (in the window and after it) against
the reference's exact top-10 in float64: the share of the reference's
neighbours found in the program's answer.  Held to the configuration's
stated floor (sense ``min``): a walk that stops early, strays or returns
its start lands far below it."""


def reading(ctx) -> float:
    found, nq = ctx.hits(ctx.answered())
    return found / max(1, nq * ctx.k)
