"""Sweeps a relocalization: kernel B1's launches (one a sweep) in the
window's requests over those requests (`kernels.LAUNCHES`)."""


def read(ctx):
    reqs = ctx.res["requests"]
    if not reqs:
        return None
    return sum(r["b1_launches"] for r in reqs) / len(reqs)
