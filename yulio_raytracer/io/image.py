"""Image load/store — the `common/image` layer.

The reference dispatches codecs by extension with an image cache
(`image/image.cpp:61-95`, caches in `loaders.cpp:29-66`).  We keep the
dispatch + cache shape.  The formats the render path reads and writes
are coded here in numpy + zlib, so it needs no imaging library: PPM/PFM
(exact semantics, `ppm.cpp` / `pfm.cpp`), PNG (read: 1-16 bit, every
colour type, no interlacing; write: 8-bit) and baseline JPEG (write:
4:4:4, the standard IJG tables scaled by quality).  Other formats (JPEG
textures, BMP, TGA, ...) go through Pillow when it is installed.
Returns float32 RGB(A) arrays in [0,1] (LDR) or linear radiance (PFM).
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_cache: dict = {}


def load(path: str) -> np.ndarray:
    """Load an image as (H, W, 3|4) float32. Cached by absolute path,
    mirroring rtLoadImage's filename cache (loaders.cpp:29-43)."""
    key = os.path.abspath(path)
    if key in _cache:
        return _cache[key]
    ext = os.path.splitext(path)[1].lower()
    if ext == '.ppm':
        img = _load_ppm(path)
    elif ext == '.pfm':
        img = _load_pfm(path)
    elif ext == '.exr':
        from . import exr
        img = exr.load_exr(path)
    elif ext == '.png':
        img = to_float_rgb(read_png(path))
    else:
        from PIL import Image
        with Image.open(path) as im:
            if im.mode not in ('RGB', 'RGBA'):
                im = im.convert('RGBA' if 'A' in im.getbands() else 'RGB')
            img = np.asarray(im).astype(np.float32) / 255.0
    _cache[key] = img
    return img


def store(path: str, img: np.ndarray, jpeg_quality: int = 90):
    """Store u8 or float image; float is clamped+quantized for LDR formats
    (storeImage dispatch, image.cpp:77-95)."""
    ext = os.path.splitext(path)[1].lower()
    arr = np.asarray(img)
    if ext == '.pfm':
        _store_pfm(path, arr.astype(np.float32))
        return
    if ext == '.exr':
        from . import exr
        exr.store_exr(path, arr.astype(np.float32))
        return
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if ext == '.ppm':
        _store_ppm(path, arr)
        return
    if ext == '.png':
        write_png(path, arr)
        return
    if ext in ('.jpg', '.jpeg'):
        write_jpeg(path, arr, quality=jpeg_quality)
        return
    from PIL import Image
    im = Image.fromarray(arr)
    if ext in ('.jpg', '.jpeg'):
        if im.mode == 'RGBA':
            im = im.convert('RGB')
        im.save(path, quality=jpeg_quality)
    else:
        im.save(path)


def _tokens(f):
    """PPM header tokenizer with '#' comments."""
    while True:
        line = f.readline()
        if not line:
            return
        line = line.split(b'#')[0]
        for t in line.split():
            yield t


def _load_ppm(path: str) -> np.ndarray:
    with open(path, 'rb') as f:
        tok = _tokens(f)
        magic = next(tok)
        if magic not in (b'P6', b'P3'):
            raise ValueError(f"unsupported PPM magic {magic!r}")
        w = int(next(tok))
        h = int(next(tok))
        maxval = int(next(tok))
        if magic == b'P6':
            data = np.frombuffer(f.read(w * h * 3), np.uint8)
        else:
            data = np.asarray([int(next(tok)) for _ in range(w * h * 3)],
                              np.uint8)
        return (data.reshape(h, w, 3).astype(np.float32) / maxval)


def _store_ppm(path: str, arr: np.ndarray):
    h, w = arr.shape[:2]
    with open(path, 'wb') as f:
        f.write(b'P6\n%d %d\n255\n' % (w, h))
        f.write(arr[..., :3].tobytes())


def _load_pfm(path: str) -> np.ndarray:
    with open(path, 'rb') as f:
        magic = f.readline().strip()
        if magic not in (b'PF', b'Pf'):
            raise ValueError("not a PFM file")
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        ch = 3 if magic == b'PF' else 1
        data = np.frombuffer(f.read(w * h * ch * 4), np.float32)
        if scale > 0:          # big-endian
            data = data.byteswap()
        img = data.reshape(h, w, ch)[::-1]  # PFM rows are bottom-up
        if ch == 1:
            img = img[..., None].repeat(3, -1).reshape(h, w, 3)
        return np.ascontiguousarray(img)


def _store_pfm(path: str, arr: np.ndarray):
    h, w = arr.shape[:2]
    with open(path, 'wb') as f:
        f.write(b'PF\n%d %d\n-1.0\n' % (w, h))
        f.write(np.ascontiguousarray(arr[::-1, :, :3], np.float32).tobytes())


def clear_cache():
    _cache.clear()


# ------------------------------------------------------------------ PNG
_PNG_SIG = b'\x89PNG\r\n\x1a\n'
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def to_float_rgb(a: np.ndarray) -> np.ndarray:
    """(H, W, C) integer samples -> float32 RGB or RGBA in [0, 1]."""
    peak = 65535.0 if a.dtype == np.uint16 else 255.0
    if a.shape[2] in (1, 2):                       # gray (+ alpha)
        a = np.concatenate([a[..., :1]] * 3 + [a[..., 1:]], axis=-1)
    return a.astype(np.float32) / peak


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray):
    """8-bit gray, gray+alpha, RGB or RGBA PNG ((H, W) or (H, W, C)
    uint8).  Rows use the Sub filter; zlib does the rest."""
    a = np.asarray(img, np.uint8)
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = a.reshape(h, w * c).astype(np.int16)
    sub = rows.copy()
    sub[:, c:] -= rows[:, :-c]
    raw = np.empty((h, w * c + 1), np.uint8)
    raw[:, 0] = 1                                   # filter type Sub
    raw[:, 1:] = sub & 0xFF
    with open(path, 'wb') as f:
        f.write(_PNG_SIG)
        f.write(_png_chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, ctype,
                                                0, 0, 0)))
        f.write(_png_chunk(b'IDAT', zlib.compress(raw.tobytes(), 6)))
        f.write(_png_chunk(b'IEND', b''))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG scanline filtering -> (h, stride) uint8.  Rows that only
    use None/Sub/Up decode row by row; otherwise a pixel depends on its
    left, upper and upper-left neighbours, so pixels decode along
    anti-diagonals, each one vectorized over rows."""
    rows = np.frombuffer(raw, np.uint8)[:h * (stride + 1)]
    rows = rows.reshape(h, stride + 1)
    ftype = rows[:, 0].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError('bad PNG filter type %d' % ftype.max())
    wp = stride // bpp
    filt = rows[:, 1:].reshape(h, wp, bpp).astype(np.int32)
    out = np.zeros((h + 1, wp + 1, bpp), np.int32)  # zero row/col border
    if ftype.max(initial=0) <= 2:
        for r in range(h):
            x = filt[r]
            if ftype[r] == 1:
                x = np.cumsum(x, axis=0)
            elif ftype[r] == 2:
                x = x + out[r, 1:]
            out[r + 1, 1:] = x & 0xFF
    else:
        t_all = ftype[:, None]
        for k in range(h + wp - 1):
            r = np.arange(max(0, k - wp + 1), min(h - 1, k) + 1)
            x = k - r
            a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
            t = t_all[r]
            pred = np.select([t == 0, t == 1, t == 2, t == 3],
                             [0, a, b, (a + b) >> 1], _paeth(a, b, c))
            out[r + 1, x + 1] = (filt[r, x] + pred) & 0xFF
    return out[1:, 1:].reshape(h, stride).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode a non-interlaced PNG -> (H, W, C) uint8 (uint16 for 16-bit
    files); C is 1 (gray), 2 (gray+alpha), 3 (RGB) or 4 (RGBA).  Palette
    images expand to RGB, or RGBA when they carry transparency."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError('%s: not a PNG file' % path)
    pos, idat, plte, trns, hdr = 8, [], None, None, None
    while pos < len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b'IHDR':
            hdr = struct.unpack('>IIBBBBB', body)
        elif kind == b'PLTE':
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b'tRNS':
            trns = np.frombuffer(body, np.uint8)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace:
        raise ValueError('%s: interlaced PNG is not supported' % path)
    ch = _PNG_CHANNELS[ctype]
    bits = depth * ch
    stride = (w * bits + 7) // 8
    rows = _unfilter(zlib.decompress(b''.join(idat)), h, stride,
                     max(bits // 8, 1))
    if depth == 16:
        a = rows.view('>u2').astype(np.uint16).reshape(h, w, ch)
    elif depth == 8:
        a = rows.reshape(h, w, ch)
    else:                                   # 1/2/4-bit gray or palette
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        a = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        a = a.reshape(h, stride * per)[:, :w, None].astype(np.uint8)
        if ctype == 0:                      # rescale gray to 8 bits
            a = (a.astype(np.uint32) * 255 // ((1 << depth) - 1)
                 ).astype(np.uint8)
    if ctype == 3:
        idx = a[..., 0]
        rgb = plte[idx]
        if trns is not None:
            alpha = np.full(len(plte), 255, np.uint8)
            alpha[:len(trns)] = trns[:len(plte)]
            return np.concatenate([rgb, alpha[idx][..., None]], axis=-1)
        return rgb
    return a


# ----------------------------------------------------------------- JPEG
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# ITU T.81 Annex K.1 quantization tables (natural order)
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.full(64, 99)
_Q_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25, 26, 32, 33]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 99, 47, 66, 99, 99]
# ... and Annex K.3 Huffman tables: (BITS, HUFFVAL)
_AC_LUMA_VALS = bytes.fromhex(
    '01020300041105122131410613516107227114328191a1082342b1c11552d1f0'
    '2433627282090a161718191a25262728292a3435363738393a43444546474849'
    '4a535455565758595a636465666768696a737475767778797a83848586878889'
    '8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5'
    'c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8'
    'f9fa')
_AC_CHROMA_VALS = bytes.fromhex(
    '000102031104052131061241510761711322328108144291a1b1c109233352f0'
    '156272d10a162434e125f11718191a262728292a35363738393a434445464748'
    '494a535455565758595a636465666768696a737475767778797a828384858687'
    '88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3'
    'c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8'
    'f9fa')
_HUFF = {
    'dc0': ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
            bytes(range(12))),
    'dc1': ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
            bytes(range(12))),
    'ac0': ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d),
            _AC_LUMA_VALS),
    'ac1': ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
            _AC_CHROMA_VALS),
}


def _huff_codes(bits, vals):
    """Canonical Huffman (T.81 Annex C): symbol -> (code, length)."""
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(bits, start=1):
        for _ in range(n):
            code_of[vals[k]] = code
            len_of[vals[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _dct_matrix():
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    c = np.where(u == 0, np.sqrt(0.5), 1.0)
    return 0.5 * c * np.cos((2 * x + 1) * u * np.pi / 16)


def _quant_table(base, quality):
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


# bit length of 0..2^15 (JPEG size categories; 8-bit DC differences
# reach 2^11)
_BITLEN = np.zeros(1 << 15, np.int64)
_BITLEN[1:] = np.floor(np.log2(np.arange(1, 1 << 15))).astype(np.int64) + 1


def _magnitude(v):
    """JPEG size category and its extra bits for signed coefficients."""
    v = v.astype(np.int64)
    size = _BITLEN[np.abs(v)]
    bits = np.where(v < 0, v + (1 << size) - 1, v)
    return size, bits


def _entropy_items(coef, cid, comp):
    """Huffman items of every block in scan order: (codes, lengths).
    coef: (nblocks, 64) quantized, zigzag order; cid: (nblocks,)
    component (DC prediction runs per component); comp: (nblocks,) table
    id (0 luma, 1 chroma).  One item is a Huffman code followed by its
    extra bits, at most 27 bits."""
    tabs = {k: _huff_codes(*v) for k, v in _HUFF.items()}
    dc_code = np.stack([tabs['dc0'][0], tabs['dc1'][0]])
    dc_len = np.stack([tabs['dc0'][1], tabs['dc1'][1]])
    ac_code = np.stack([tabs['ac0'][0], tabs['ac1'][0]])
    ac_len = np.stack([tabs['ac0'][1], tabs['ac1'][1]])
    nblk = coef.shape[0]
    # DC: differences along each component's own block sequence
    dc = coef[:, 0].astype(np.int64)
    diff = np.empty(nblk, np.int64)
    for c in np.unique(cid):
        sel = np.nonzero(cid == c)[0]
        d = dc[sel]
        diff[sel] = d - np.concatenate([[0], d[:-1]])
    size, bits = _magnitude(diff)
    dc_items = (dc_code[comp, size] << size) | bits
    dc_lens = dc_len[comp, size] + size
    # AC: (run, size) symbols, ZRL for runs >= 16, EOB after the last
    ac = coef[:, 1:]
    nzb, nzk = np.nonzero(ac)
    val = ac[nzb, nzk]
    first = np.ones(len(nzb), bool)
    first[1:] = nzb[1:] != nzb[:-1]
    prevk = np.where(first, -1, np.roll(nzk, 1))
    run = nzk - prevk - 1
    nzrl = run >> 4
    size, bits = _magnitude(val)
    sym = ((run & 15) << 4) | size
    c_nz = comp[nzb]
    nz_items = (ac_code[c_nz, sym] << size) | bits
    nz_lens = ac_len[c_nz, sym] + size
    nnz = np.bincount(nzb, minlength=nblk)
    zrl = np.bincount(nzb, weights=nzrl, minlength=nblk).astype(np.int64)
    last = np.full(nblk, -1, np.int64)
    is_last = np.ones(len(nzb), bool)
    is_last[:-1] = nzb[1:] != nzb[:-1]
    last[nzb[is_last]] = nzk[is_last]
    eob = last < 62
    count = 1 + nnz + zrl + eob
    start = np.cumsum(count) - count
    # position of every nonzero's item inside the block's item list
    nz_base = (np.cumsum(nnz) - nnz)[nzb]
    cz = np.cumsum(nzrl)
    cz_base = (np.cumsum(zrl) - zrl)[nzb]
    pos_nz = start[nzb] + 1 + (np.arange(len(nzb)) - nz_base) \
        + (cz - cz_base)
    total = int(count.sum())
    codes = np.empty(total, np.int64)
    lens = np.empty(total, np.int64)
    codes[start] = dc_items
    lens[start] = dc_lens
    codes[pos_nz] = nz_items
    lens[pos_nz] = nz_lens
    owner = np.repeat(np.arange(len(nzb)), nzrl)
    if owner.size:
        k = np.arange(owner.size) - np.repeat(np.cumsum(nzrl) - nzrl, nzrl)
        zpos = pos_nz[owner] - nzrl[owner] + k
        codes[zpos] = ac_code[c_nz[owner], 0xF0]
        lens[zpos] = ac_len[c_nz[owner], 0xF0]
    epos = (start + count - 1)[eob]
    codes[epos] = ac_code[comp[eob], 0x00]
    lens[epos] = ac_len[comp[eob], 0x00]
    return codes, lens


def _pack_bits(codes, lens) -> bytes:
    """Concatenate MSB-first variable-length items into bytes, pad the
    tail with 1-bits and stuff a 0x00 after every 0xFF (T.81 F.1.2.3).
    Each item (<= 27 bits) is placed in a 64-bit window at its first
    byte and spread over the 5 bytes it can touch; items never share a
    bit, so summing the byte contributions ORs them."""
    off = np.cumsum(lens) - lens
    nbits = int(off[-1] + lens[-1]) if len(lens) else 0
    nbytes = -(-nbits // 8)
    first = off >> 3
    w = codes.astype(np.uint64) << (64 - (off & 7) - lens).astype(np.uint64)
    acc = np.zeros(nbytes + 5, np.float64)
    for k in range(5):
        byte = ((w >> np.uint64(56 - 8 * k)) & np.uint64(0xFF))
        acc += np.bincount(first + k, weights=byte.astype(np.float64),
                           minlength=nbytes + 5)
    data = acc[:nbytes].astype(np.uint8)
    if nbits % 8:
        data[-1] |= (1 << (8 - nbits % 8)) - 1
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack('>HH', marker, len(body) + 2) + body


def write_jpeg(path: str, img: np.ndarray, quality: int = 90):
    """Write encode_jpeg(img, quality) to path."""
    with open(path, 'wb') as f:
        f.write(encode_jpeg(img, quality))


def encode_jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    """Baseline JPEG, 4:4:4, of an (H, W[, C]) uint8 image (alpha is
    dropped, gray is stored as RGB)."""
    a = np.asarray(img, np.uint8)
    if a.ndim == 2:
        a = a[..., None]
    a = a[..., :3]
    if a.shape[2] == 1:
        a = np.repeat(a, 3, axis=2)
    h, w = a.shape[:2]
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    a = np.pad(a, ((0, hp - h), (0, wp - w), (0, 0)), mode='edge')
    # RGB -> level-shifted YCbCr (T.871), then 8x8 blocks in scan order:
    # per cell Y, Cb, Cr, each block flattened row-major
    rgb2ycc = np.array([[0.299, 0.587, 0.114],
                        [-0.168736, -0.331264, 0.5],
                        [0.5, -0.418688, -0.081312]], np.float32)
    ycc = a.astype(np.float32) @ rgb2ycc.T
    ycc[..., 0] -= 128.0
    blocks = ycc.reshape(hp // 8, 8, wp // 8, 8, 3).transpose(0, 2, 4, 1, 3)
    blocks = blocks.reshape(-1, 64)
    # one 64x64 matrix per table: 2-D DCT, zigzag order, 1/quantizer
    m = _dct_matrix()
    dct = np.kron(m, m)[_ZIGZAG]
    qt = np.stack([_quant_table(_Q_LUMA, quality),
                   _quant_table(_Q_CHROMA, quality)])
    coef = np.empty(blocks.shape, np.int32)
    for c in range(3):
        t = min(c, 1)
        k = (dct / qt[t][_ZIGZAG][:, None]).T.astype(np.float32)
        coef[c::3] = np.rint(blocks[c::3] @ k)
    cid = np.tile(np.arange(3), blocks.shape[0] // 3)
    comp = np.minimum(cid, 1)
    codes, lens = _entropy_items(coef, cid, comp)
    hdr = [b'\xff\xd8',
           _segment(0xFFE0, b'JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00')]
    for tid in (0, 1):
        hdr.append(_segment(0xFFDB, bytes([tid])
                            + qt[tid][_ZIGZAG].astype(np.uint8).tobytes()))
    hdr.append(_segment(0xFFC0, struct.pack('>BHHB', 8, h, w, 3)
                        + bytes([1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for cls, name in ((0, 'dc0'), (0, 'dc1'), (1, 'ac0'), (1, 'ac1')):
        bits, vals = _HUFF[name]
        hdr.append(_segment(0xFFC4, bytes([cls << 4 | int(name[2])])
                            + bytes(bits) + vals))
    hdr.append(_segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11,
                                       0, 63, 0])))
    return b''.join(hdr) + _pack_bits(codes, lens) + b'\xff\xd9'
