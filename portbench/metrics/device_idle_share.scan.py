"""device_idle_share.scan (%): the share of the measured window in which
the card ran nothing: one minus its busy time a call (the union of its
activity in the traced window, over that window's calls) times the
measured window's calls, over its length; the mean over the cards."""

from portbench.trace import idle_share


def read(run):
    return idle_share(run)
