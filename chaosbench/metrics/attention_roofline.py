"""attention_roofline (kernels, ``csrc/flash_attention.cu``): the least
time the window's attention launches could take, each the larger of its
operations over the peak of its dtype and its bytes over the memory rate
(``yardstick.attention`` at the launch's shape, the pairs its mask
admits), over the device time of the attention kernels in the trace."""
from chaosbench import yardstick as Y


def shape(q, k, v, *, scale, softcap=0.0, kind="causal", window=0, prefix_len=0,
          q_offset=0, n_split=None):
    B, Sq, H, hd = q.shape
    return (B, Sq, k.shape[1], H, k.shape[2], hd, kind, int(window), int(prefix_len),
            int(q_offset), q.element_size())


CALLS = {"attention": ("repro_torch.kernels.flash_attention:flash_attention_kernel", shape)}


def read(run):
    calls = run.calls.get("attention", [])
    if run.trace is None or not calls:
        return None
    device = run.trace.seconds_of("flash_attention")
    if device <= 0:
        return None
    least = 0.0
    for B, Sq, Skv, H, K, hd, kind, window, prefix, q_offset, itemsize in calls:
        pairs = Y.admitted_pairs(kind, window, prefix, Sq, Skv, q_offset)
        flops, nbytes = Y.attention(B, Sq, Skv, H, K, hd, pairs, itemsize=itemsize)
        peak = Y.PEAK_BF16_FLOPS if itemsize == 2 else Y.PEAK_FP32_FLOPS
        least += Y.bound_s(flops, nbytes, peak)
    return 100.0 * least / device
