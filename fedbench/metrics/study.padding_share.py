"""The share of a Study group's local-step work that is padding: padded
sample-steps over envelope sample-steps, from each member's (b, V) and the
group's (V_env, B_env) (chip_smoke.py phase 17 (d)'s arithmetic)."""


def read(ctx):
    share = ctx.get("padding_share")
    return None if share is None else 100.0 * share
