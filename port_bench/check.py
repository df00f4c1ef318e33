"""How `correct` is decided for a served model: once the window has closed
and the port's state is freed, a sample of the requests completed in the
window, drawn from the seed with the longest among them, is run through
the plain reference (ref/<arch>.py) over its prompt and served tokens;
the number compared is the widest gap by which a served token's logit lies
below the reference's best at its position (greedy tokens only), or,
where one routing flip at a near tie moves a token's logits by whole units
(the MoE), the share of served tokens that are not the reference's best
(`disagree`): the configuration's `check.number` says which."""
from __future__ import annotations

import numpy as np
import torch


def sample(done: list, seed: int, min_tokens: int, max_requests: int, max_rows: int) -> list:
    """Completed requests to check: the one with the most served tokens,
    then others in a seeded order, until `min_tokens` served tokens or
    `max_requests` requests, keeping the reference's rows (prompt + served
    tokens) under `max_rows`."""
    if not done:
        return []
    by_rid = sorted(done, key=lambda d: d.rid)
    longest = max(by_rid, key=lambda d: (len(d.out), len(d.prompt)))
    order = [by_rid[i] for i in np.random.default_rng([seed, 7]).permutation(len(by_rid))]
    picked, toks, rows = [longest], len(longest.out), len(longest.prompt) + len(longest.out)
    for d in order:
        if toks >= min_tokens or len(picked) >= max_requests:
            break
        n = len(d.prompt) + len(d.out)
        if d is longest or rows + n > max_rows:
            continue
        picked.append(d)
        toks += len(d.out)
        rows += n
    return picked


def compare(ref_mod, hp: dict, seed: int, picked: list, device) -> dict:
    """The picked requests' served tokens against the reference: the widest
    logit gap and the share of tokens not the reference's best."""
    from .ref.common import gaps, scored_rows

    from .roofline import expected_experts, routed_experts

    seqs = [(d.prompt, d.out) for d in picked]
    routes = [] if "num_local_experts" in hp else None
    lg = ref_mod.logits(hp, seed, seqs, device, **({} if routes is None else {"routes": routes}))
    _, toks = scored_rows(seqs)
    g = gaps(lg, toks)
    out = {"logit_gap": float(g.max()), "disagree": float((g > 0).float().mean()),
           "tokens": len(toks), "requests": len(seqs)}
    if routes:
        E, U = hp["num_local_experts"], hp["num_experts_per_tok"]
        rng = np.random.default_rng([seed, 8])
        out["experts_at_T"] = {T: [routed_experts(routes, T, rng), expected_experts(E, U, T)]
                               for T in (4, 32)}
    return out


def control_gap(ref_mod, hp: dict, seed: int, seqs, device) -> dict:
    """The control: the reference in float8 (every product's operands
    rounded to e4m3 per row) read at the same prompts and tokens; the gap
    of the token the float8 logits put first, against the f32 reference."""
    from .ref.common import gaps, scored_rows

    ref = ref_mod.logits(hp, seed, seqs, device)
    low = ref_mod.logits(hp, seed, seqs, device, low=True)
    _, toks = scored_rows(seqs)
    g_served = gaps(ref, toks)
    g_low = gaps(ref, low.argmax(dim=-1).tolist())

    def stats(g):
        q = torch.quantile(g.float(), torch.tensor([0.5, 0.9], device=g.device)).tolist()
        return {"max": float(g.max()), "mean": float(g.mean()), "median": q[0], "p90": q[1],
                "agree": float((g == 0).float().mean())}

    return {"control_gap": float(g_low.max()), "served_gap": float(g_served.max()),
            "tokens": len(toks), "served": stats(g_served), "control": stats(g_low)}


def free_cuda():
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
