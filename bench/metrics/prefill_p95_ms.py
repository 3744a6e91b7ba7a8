"""Time to first token: the 95th percentile over every batch of the
window, each timed to its synchronisation."""
import statistics


def read(ctx):
    if ctx["kind"] != "prefill":
        return None
    lat = ctx["window"]["latencies_s"]
    if len(lat) < 2:
        return 1e3 * lat[0]
    return 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[18]
