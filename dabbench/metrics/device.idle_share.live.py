"""device.idle_share.live (%): share of the traced window with no kernel,
copy or memset running on the card."""

from dabbench import readers


def read(run):
    return readers.idle_share_pct(run)
