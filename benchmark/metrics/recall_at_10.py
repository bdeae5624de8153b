"""recall_at_10: over every answer of the window, the share of the query's
exact top-10 (f32 inner products, TF32 off, `lib/truth.py`) it holds."""

import torch

from benchmark.lib import truth


def read(ctx):
    w = ctx.window
    if not len(w["qidx"]):
        return None
    gt = torch.as_tensor(ctx.gt[w["qidx"]][:, :10])
    return truth.recall(torch.as_tensor(w["ids"]), gt)
