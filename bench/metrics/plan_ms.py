"""The time ``plan_pfft`` took in set-up, over every side the cell sends,
in ms, timed by the harness around each call."""


def read(run):
    return run.plan_s * 1e3
