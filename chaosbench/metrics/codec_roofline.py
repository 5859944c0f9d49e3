"""codec_roofline (kernels, ``csrc/shard_codec.cu``): the bytes the
window's int8 encodes and decodes move (``yardstick.codec_bytes``) over the
memory rate, over the device time of the encode and decode kernels in the
trace."""
from chaosbench import yardstick as Y


def encoded(leaves):
    return [x.numel() for x in leaves]


def decoded(codes_list, scales_list, numels):
    return [int(n) for n in numels]


CALLS = {"encode": ("repro_torch.kernels.shard_codec:shard_encode_many_kernel", encoded),
         "decode": ("repro_torch.kernels.shard_codec:shard_decode_many_kernel", decoded)}


def read(run):
    enc, dec = run.calls.get("encode", []), run.calls.get("decode", [])
    if run.trace is None or not (enc or dec):
        return None
    device = run.trace.seconds_of("shard_encode") + run.trace.seconds_of("shard_decode")
    if device <= 0:
        return None
    nbytes = sum(Y.codec_bytes(n) for n in enc + dec)
    return 100.0 * nbytes / Y.PEAK_BYTES_PER_S / device
