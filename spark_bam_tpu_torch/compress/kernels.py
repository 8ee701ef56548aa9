"""The write path's device lanes (reference ``spark_bam_tpu/compress/
kernels.py``): batched CRC-32 and literal-only fixed-Huffman DEFLATE of
payload lanes, ``(B, STRIDE)`` u8 with a length a lane.

| wrapper                 | CUDA source         | replaces (spark_bam_tpu/compress/kernels.py) |
| ----------------------- | ------------------- | -------------------------------------------- |
| ``crc32_lanes``         | ``csrc/deflate.cu`` | ``crc32_lanes`` (``:100``, ``_crc_body`` ``:69``) |
| ``deflate_fixed_lanes`` | ``csrc/deflate.cu`` | ``deflate_fixed_lanes`` (``:107``)           |

The reference's are jnp/XLA programs, not Pallas; here each is a CUDA
kernel (one CTA a lane; the source notes what bounds it and how its design
answers). A wrapper launches its kernel for CUDA tensors, or raises; it
takes its plain PyTorch version (``crc32_lanes_plain``,
``deflate_fixed_lanes_plain``, the reference's arithmetic) only for
tensors on the CPU. Launches count in ``tpu.kernels.LAUNCHES``.

``pack_lanes`` stages payloads into lanes, in pinned host memory when the
lanes go to the card. There is no power-of-two batch pad: PyTorch has no
jit whose shapes it would keep stable.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_bam_tpu_torch.bgzf.block import MAX_BLOCK_SIZE
from spark_bam_tpu_torch.compress.huffman import RCODE
from spark_bam_tpu_torch.tpu.kernels import _check, _launch, _on_cuda

#: Fixed lane width: one BGZF payload never exceeds this.
STRIDE = MAX_BLOCK_SIZE
#: Output byte plane per lane: a useful fixed stream is < payload + 5
#: bytes (else stored wins), so STRIDE + 8 covers every kept result.
OUT_BYTES = STRIDE + 8
_POLY = 0xEDB88320


def _crc_tables() -> np.ndarray:
    """Slice-by-4 CRC-32 tables, ``(4, 256) u32``; row 0 is the standard
    reflected CRC-32 (poly 0xEDB88320) byte table."""
    t = np.zeros((4, 256), dtype=np.uint64)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        t[0, i] = c
    for k in range(1, 4):
        prev = t[k - 1]
        t[k] = (prev >> 8) ^ t[0][prev & 0xFF]
    return t.astype(np.uint32)


_T = _crc_tables()


def _crc_consts() -> np.ndarray:
    """The kernels' constants, 2,304 u32: the byte table, then for k =
    0..15 the operator Z_{2^k} that advances a CRC register over 2^k zero
    bytes, as 8 nibble tables of 16 words (``Z(v)`` is the XOR of
    ``table[p][(v >> 4p) & 15]`` over p)."""
    t0 = [int(x) for x in _T[0]]

    def apply(cols, v):
        r = 0
        for i in range(32):
            if (v >> i) & 1:
                r ^= cols[i]
        return r

    ops = [[((1 << i) >> 8) ^ t0[(1 << i) & 0xFF] for i in range(32)]]
    for _ in range(15):
        prev = ops[-1]
        ops.append([apply(prev, prev[i]) for i in range(32)])
    nib = np.zeros((16, 8, 16), dtype=np.uint32)
    for k, cols in enumerate(ops):
        for p in range(8):
            for v in range(16):
                nib[k, p, v] = apply(cols, v << (4 * p))
    return np.concatenate([_T[0], nib.ravel()])


_CONSTS: dict = {}


def _consts(dev: torch.device) -> torch.Tensor:
    """The constants on ``dev``, uploaded once."""
    if dev not in _CONSTS:
        host = torch.from_numpy(_crc_consts().view(np.int32))
        _CONSTS[dev] = host.to(dev).view(torch.uint32)
    return _CONSTS[dev]


def pack_lanes(payloads: "list[bytes]", pin: bool = False):
    """Host staging: payloads → ``(data (b, STRIDE) u8, lengths (b,) i32,
    b)``, each lane zero-padded past its length; in pinned memory with
    ``pin``, so that the copy to the card can run without waiting."""
    b = len(payloads)
    data = torch.empty((b, STRIDE), dtype=torch.uint8, pin_memory=pin)
    lengths = torch.empty(b, dtype=torch.int32, pin_memory=pin)
    arr, lens = data.numpy(), lengths.numpy()
    for i, p in enumerate(payloads):
        n = len(p)
        if n > STRIDE:
            raise ValueError(f"{n}-byte payload is wider than a lane "
                             f"({STRIDE})")
        arr[i, :n] = np.frombuffer(p, dtype=np.uint8)
        arr[i, n:] = 0
        lens[i] = n
    return data, lengths, b


def _check_lanes(data: torch.Tensor, lengths: torch.Tensor) -> None:
    dev = data.device
    _check(data, "data", torch.uint8, 2, dev)
    _check(lengths, "lengths", torch.int32, 1, dev)
    if data.shape[1] != STRIDE or lengths.shape[0] != data.shape[0]:
        raise ValueError(f"lanes must be (B, {STRIDE}) with (B,) lengths, got "
                         f"{tuple(data.shape)} / {tuple(lengths.shape)}")
    if data.data_ptr() % 16:
        raise ValueError("data must start on a 16-byte boundary")


def crc32_lanes(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """``(B,) u32`` CRC-32 of each lane's first ``lengths[i]`` bytes (0 for
    length 0): the whole device side of stored members."""
    if not _on_cuda(data):
        return crc32_lanes_plain(data, lengths)
    _check_lanes(data, lengths)
    dev = data.device
    b = data.shape[0]
    crc = torch.empty(b, dtype=torch.uint32, device=dev)
    if b:
        _launch("crc32_lanes", "sbt_crc32_lanes", data.data_ptr(),
                lengths.data_ptr(), b, _consts(dev).data_ptr(),
                crc.data_ptr(), device=dev)
    return crc


def deflate_fixed_lanes(data: torch.Tensor, lengths: torch.Tensor):
    """Fixed-Huffman pack and CRC-32 of every lane in one launch:
    ``(packed (B, OUT_BYTES) u8, total_bits (B,) i32, crc (B,) u32)``.
    ``packed``'s first ``ceil(total_bits / 8)`` bytes are the complete
    DEFLATE body (``huffman.fixed_pack``'s bytes), the rest zeros. A lane
    whose stream outgrows ``OUT_BYTES`` has its tail bits dropped; its
    ``total_bits`` keeps the true size."""
    if not _on_cuda(data):
        return deflate_fixed_lanes_plain(data, lengths)
    _check_lanes(data, lengths)
    dev = data.device
    b = data.shape[0]
    packed = torch.empty((b, OUT_BYTES), dtype=torch.uint8, device=dev)
    total_bits = torch.empty(b, dtype=torch.int32, device=dev)
    crc = torch.empty(b, dtype=torch.uint32, device=dev)
    if packed.data_ptr() % 4:
        raise ValueError("packed must start on a 4-byte boundary")
    if b:
        _launch("deflate_fixed_lanes", "sbt_deflate_fixed_lanes",
                data.data_ptr(), lengths.data_ptr(), b,
                _consts(dev).data_ptr(), packed.data_ptr(),
                total_bits.data_ptr(), crc.data_ptr(), device=dev)
    return packed, total_bits, crc


# ------------------------------------------------------------ plain versions


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → the same bits as u32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32).view(
        torch.uint32)


def crc32_lanes_plain(data: torch.Tensor, lengths: torch.Tensor
                      ) -> torch.Tensor:
    """The reference's ``_crc_body`` in PyTorch: slice-by-4 over 4-byte
    groups across all lanes at once; a group that straddles a lane's end
    goes byte by byte, masked (zero padding would change the digest)."""
    dev = data.device
    b_dim, stride = data.shape
    if b_dim == 0:
        return torch.empty(0, dtype=torch.uint32, device=dev)
    t = torch.from_numpy(_T.astype(np.int64)).to(dev)
    lens = lengths.to(dev).long().clamp(0, stride)
    d = torch.nn.functional.pad(data, (0, 3))
    crc = torch.full((b_dim,), 0xFFFFFFFF, dtype=torch.int64, device=dev)
    lens_host = lens.tolist()
    n_groups = (max(lens_host) + 3) // 4
    straddle = {n // 4 for n in lens_host if n % 4}
    for g in range(n_groups):
        grp = d[:, 4 * g: 4 * g + 4].long()
        word = grp[:, 0] | grp[:, 1] << 8 | grp[:, 2] << 16 | grp[:, 3] << 24
        c = crc ^ word
        full = (t[3][c & 0xFF] ^ t[2][(c >> 8) & 0xFF]
                ^ t[1][(c >> 16) & 0xFF] ^ t[0][c >> 24])
        if g in straddle:
            bw = crc
            for j in range(4):
                step = (bw >> 8) ^ t[0][(bw ^ grp[:, j]) & 0xFF]
                bw = torch.where(4 * g + j < lens, step, bw)
        else:
            bw = crc
        crc = torch.where(4 * g + 4 <= lens, full, bw)
    return _u32(crc ^ 0xFFFFFFFF)


def deflate_fixed_lanes_plain(data: torch.Tensor, lengths: torch.Tensor):
    """``deflate_fixed_lanes`` in PyTorch: per-byte code lengths and
    bit-reversed codes, an exclusive cumulative sum for every code's bit
    offset (3 header bits lead), then each code's (at most two) bytes
    added into a zeroed plane; bits are unique, so the adds are ORs."""
    dev = data.device
    b_dim, stride = data.shape
    lens = lengths.to(dev).long().clamp(0, stride)
    byte = data.long()
    valid = torch.arange(stride, device=dev)[None, :] < lens[:, None]
    nb = torch.where(valid, 8 + (byte >= 144).long(), 0)
    pos = 3 + torch.cumsum(nb, dim=1) - nb
    total_bits = (3 + nb.sum(dim=1) + 7).to(torch.int32)
    rc = torch.from_numpy(RCODE.astype(np.int64)).to(dev)[byte]
    v = rc << (pos & 7)
    at = (torch.arange(b_dim, device=dev)[:, None] * OUT_BYTES + (pos >> 3))
    plane = torch.zeros(b_dim * OUT_BYTES, dtype=torch.int32, device=dev)
    for shift, k in ((0, 0), (8, 1)):
        keep = valid & ((pos >> 3) + k < OUT_BYTES)   # clip: stored wins
        plane.index_add_(0, (at + k)[keep],
                         ((v >> shift) & 0xFF)[keep].to(torch.int32))
    plane = plane.view(b_dim, OUT_BYTES)
    plane[:, 0] += 3                                  # BFINAL=1, BTYPE=01
    return (plane.to(torch.uint8), total_bits,
            crc32_lanes_plain(data, lengths))
