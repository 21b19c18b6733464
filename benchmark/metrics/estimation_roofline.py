"""Percent of the roofline of the zero-order estimation sweep's counted
work (the T nominal contact QPs at the full PDIP count and the T*S sample
QPs at the surrogate's) over the device time of every kernel launched
inside the estimation spans.  Not read where the mode draws no samples."""
from benchmark import counts
from benchmark.readers import roofline

SOURCE = "device_trace"


def read(run):
    c = run.config

    def work(shape):
        if shape["mode"] != "zero_order_B":
            return None
        return counts.estimation_work(shape["T"], shape["S"], c["nq"],
                                      c["contact_rows"], c["qp_iters"],
                                      c["surrogate_qp_iters"])

    return roofline(run, "estimation", work)
