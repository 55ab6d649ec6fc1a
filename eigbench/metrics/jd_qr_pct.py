"""JD host loop: the device time of the kernels launched inside the
program's ``jd.orthogonalize`` spans (the projections and QR of the
correction block) over that of the kernels launched inside its
``jd.iteration`` spans, in %, over the profiled requests."""

from eigbench import spans


def read(run):
    return spans.read_metric(run, "jd_qr_pct", spans.device_share,
                             "jd.orthogonalize", "jd.iteration")
