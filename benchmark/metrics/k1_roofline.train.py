"""k1_roofline.train: K1's least time over its device time, in the profiled steps.

The least time is the sum over K1's launches (the port's own count, by rows
M) of ``benchmark/peaks.py``'s ``k1_bound_ms`` at In = hidden_dim, H =
deter_dim; the device time is every kernel of K1 by name (``k1::``) in the
trace, the LayerNorm passes included. Silent where K1 did not run.
"""


def read(run):
    from benchmark.peaks import peaks_for

    rows = run.counters.get("k1_by_rows", {})
    k1_s = run.trace.device_s(lambda name: "k1::" in name)
    if not rows or k1_s <= 0 or run.card == "cpu":
        return None
    _, peaks = peaks_for(run.device_name)
    c = run.conf
    bf16 = c["precision"] == "bfloat16"
    from benchmark.peaks import k1_bound_ms
    bound_ms = sum(n * k1_bound_ms(int(m), c["hidden_dim"], c["deter_dim"], peaks, bf16)[0]
                   for m, n in rows.items())
    return 100.0 * bound_ms / (k1_s * 1e3)
