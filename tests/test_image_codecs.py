"""The numpy + zlib image codecs of io/image.py, checked against Pillow
where it is installed: PNG pixels round-trip exactly in both directions,
and a JPEG written here decodes at >= 35 dB PSNR at quality 90."""
import numpy as np
import pytest

from yulio_raytracer.io import image

PIL = pytest.importorskip('PIL.Image')


def _smooth(h=203, w=317, seed=0):
    """A render-like image: smooth gradients plus mild noise."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 20.0),
                    128 + 80 * np.cos(yy / 15.0),
                    (xx + yy) * 0.4], -1)
    return np.clip(img + rs.randn(*img.shape) * 2, 0, 255).astype(np.uint8)


def _psnr(a, b):
    mse = ((np.asarray(a, np.float64) - b) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


@pytest.mark.parametrize('channels', [1, 2, 3, 4])
def test_png_written_here_reads_exactly_in_pillow(tmp_path, channels):
    img = _smooth()
    a = np.concatenate([img, img[..., :1]], -1)[..., :channels]
    if channels == 2:
        a = img[..., :2]
    p = str(tmp_path / 'a.png')
    image.write_png(p, a)
    back = np.asarray(PIL.open(p))
    np.testing.assert_array_equal(back.reshape(a.shape), a)
    np.testing.assert_array_equal(image.read_png(p), a)


@pytest.mark.parametrize('mode', ['RGB', 'RGBA', 'L', 'LA', 'P', '1',
                                  'I;16'])
def test_png_written_by_pillow_reads_exactly_here(tmp_path, mode):
    img = _smooth(seed=1)
    if mode == 'I;16':
        im = PIL.fromarray(img[..., 0].astype(np.uint16) * 257)
    else:
        im = PIL.fromarray(img).convert(mode)
    p = str(tmp_path / 'b.png')
    im.save(p, optimize=True)          # adaptive filters, Paeth included
    want = PIL.open(p)
    want = want.convert({'P': 'RGB', '1': 'L'}.get(mode, want.mode))
    want = np.asarray(want)
    got = image.read_png(p)
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_png_palette_transparency(tmp_path):
    p = str(tmp_path / 'c.png')
    PIL.fromarray(_smooth(seed=2)).convert('P').save(p, transparency=3)
    want = np.asarray(PIL.open(p).convert('RGBA'))
    np.testing.assert_array_equal(image.read_png(p), want)


@pytest.mark.parametrize('shape', [(8, 8), (13, 21), (64, 40), (203, 317)])
def test_jpeg_quality_90_psnr(tmp_path, shape):
    img = _smooth(*shape, seed=3)
    p = str(tmp_path / 'd.jpg')
    image.write_jpeg(p, img, quality=90)
    back = np.asarray(PIL.open(p).convert('RGB'))
    assert back.shape == img.shape
    assert _psnr(back, img) >= 35.0


def test_jpeg_quality_scales_size_and_error(tmp_path):
    img = _smooth(seed=4)
    sizes, psnrs = [], []
    for q in (30, 75, 95):
        data = image.encode_jpeg(img, quality=q)
        p = tmp_path / ('q%d.jpg' % q)
        p.write_bytes(data)
        sizes.append(len(data))
        psnrs.append(_psnr(np.asarray(PIL.open(str(p))), img))
    assert sizes[0] < sizes[1] < sizes[2]
    assert psnrs[0] < psnrs[1] < psnrs[2]


def test_store_and_load_dispatch_without_pillow(tmp_path, monkeypatch):
    """.png and .jpg go through the codecs here even when Pillow cannot
    be imported; the watermark resource decodes through read_png."""
    import builtins
    from yulio_raytracer.film import stereo_strip
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == 'PIL' or name.startswith('PIL.'):
            raise ImportError('no Pillow')
        return real_import(name, *a, **k)
    monkeypatch.setattr(builtins, '__import__', no_pil)
    img = _smooth(seed=5)
    image.store(str(tmp_path / 'e.png'), img)
    image.store(str(tmp_path / 'e.jpg'), img, jpeg_quality=90)
    image.clear_cache()
    back = image.load(str(tmp_path / 'e.png'))
    np.testing.assert_array_equal(np.round(back * 255).astype(np.uint8),
                                  img)
    assert (tmp_path / 'e.jpg').read_bytes()[:2] == b'\xff\xd8'
    wm = stereo_strip.load_watermark()
    assert wm.shape == (100, 100, 4) and wm[..., 3].max() > 0
