"""Mean host time inside the program's ``execute`` until it returns, in ms:
the enqueue of a request, timed by the harness's span around the call."""


def read(run):
    done = run.done
    if not done:
        return None
    return sum(r.enqueued - r.start for r in done) / len(done) * 1e3
