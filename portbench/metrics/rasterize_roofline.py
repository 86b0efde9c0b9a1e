"""The event raster's share (%) of its roofline over the traced stretch:
each recorded launch's least time (the packet's (x, y, value) lanes read
and the frame written once, at the card's HBM rate, against its float32
operations at the float32 peak) summed, over the launches' summed device
times. Read only where the trace recorded every launch of the raster that
the launch ledger counted in the stretch: a launch the profiler missed
(as it misses most of a WHILE body's) would leave the share resting on
the launches it happened to keep."""
from portbench import roofline

KERNEL = "raster_cluster_kernel"
# the raster's launch counter in the program's launch ledger
LEDGER = "rasterize_bilinear"


def read(rec):
    st = rec["stretch"]
    if st is None or not rec["events_per_packet"]:
        return None
    times = st.kernel_times(KERNEL)
    runs = (st.ledger_runs or {}).get(LEDGER)
    if not times or runs != len(times):
        return None
    cam = rec["camera"]
    b = roofline.bound_s(*roofline.raster_launch(
        rec["events_per_packet"], cam.height, cam.width))
    return roofline.share([b] * len(times), times)
