"""Host ms from the start of a fresh learner's construction to the return of
its ``meta_fit`` (no synchronize inside: host work only), the mean over the
window's fits that built a learner."""


def read(run):
    spans = [r["ret"] - r["start"] for r in run.driver.records
             if r["constructed"] and r["ret"] is not None]
    return 1e3 * sum(spans) / len(spans) if spans else None
