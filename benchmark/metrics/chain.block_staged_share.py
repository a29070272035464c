"""Share of the captured chain's replays whose k frames crossed to the card
as one host block written at feed (``utils/staging.HostBlock``): the
counters ``chain.block_stages`` over ``chain.replays``, process totals over
the run. 1 where every chain of host frames takes the block; a program
without the block gives None."""

from program import counter_ratio


def read(ctx):
    return counter_ratio(ctx, "chain.block_stages", "chain.replays", "video")
