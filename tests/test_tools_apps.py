"""Collectors (gated), benchmark harness, minifier, app import gating."""

import json
import os

import numpy as np
import pytest

from aegis_tpu.tools.collectors import (BatchCollector, CollectorConfig,
                                        have_ytdlp, normalize_title,
                                        package_zip)
from aegis_tpu.tools.minify_html import minify_html


def test_normalize_title():
    assert normalize_title("Song (Official Video) [HD]!") == "song"
    assert normalize_title("  Foo   Bar  ") == "foo_bar"
    assert normalize_title("") == "untitled"


def test_collector_gating(tmp_path):
    c = BatchCollector(CollectorConfig(output_dir=str(tmp_path)))
    if not have_ytdlp():
        assert c.search("test") == []
        assert c.download("test query") is None
        assert c.stats.downloaded == 0


def test_collector_blocklist_and_dedup(tmp_path):
    c = BatchCollector(CollectorConfig(output_dir=str(tmp_path)))
    assert c._blocked("Great Song (Live at Venue)")
    assert not c._blocked("Great Song")
    # dedup key detection from folder
    p = tmp_path / "great_song.mp3"
    p.write_bytes(b"x" * 2048)
    keys = c._existing_keys(str(tmp_path))
    assert "great_song" in keys
    # small files re-download (not counted as existing)
    (tmp_path / "tiny.mp3").write_bytes(b"x")
    assert "tiny" not in c._existing_keys(str(tmp_path))


def test_package_zip(tmp_path):
    folder = tmp_path / "col"
    folder.mkdir()
    (folder / "a.mp3").write_bytes(b"abc")
    out = package_zip(str(folder), str(tmp_path / "out.zip"))
    assert os.path.getsize(out) > 0


def test_benchmark_harness():
    from aegis_tpu.tools.benchmark import run_benchmark

    result = run_benchmark(duration_per_note=0.4, backend="ref")
    assert result["truth_notes"] == 8
    # the engine must beat the naive no-filter baseline on F1
    assert result["aegis"]["f1"] > result["naive_baseline"]["f1"]
    assert result["aegis"]["recall"] >= 0.8


def test_minify_html():
    src = """<!-- comment --><html><head><style>
/* css comment */ body { color: red; }
</style><script>
// js comment
const url = "http://x/y"; /* block */ let a = 1;
</script></head>
<body>  <p>hi</p>  </body></html>"""
    out = minify_html(src, manifest="test")
    assert "comment" not in out
    assert "http://x/y" in out  # URL survived
    assert "aegis_tpu SPA | test" in out
    assert "><" in out


def test_apps_import_gating():
    # app modules import cleanly; main() raises a helpful ImportError
    # only when streamlit is missing
    import aegis_tpu.apps.collector_studio as cs
    import aegis_tpu.apps.financial_batch as fb
    import aegis_tpu.apps.financial_realtime as fr
    import aegis_tpu.apps.intelligence_dashboard as dash
    import aegis_tpu.apps.tuning_center as tc

    try:
        import streamlit  # noqa: F401

        has_st = True
    except ImportError:
        has_st = False
    if not has_st:
        for mod in (tc, fr, cs, dash, fb):
            with pytest.raises(ImportError, match="streamlit"):
                mod.main()


def test_dashboard_simulated_trends_deterministic():
    from aegis_tpu.apps.intelligence_dashboard import GENRES, _simulated_trends

    i1, h1 = _simulated_trends()
    i2, h2 = _simulated_trends()
    assert i1 == i2 and np.allclose(h1, h2)
    assert set(i1) == set(GENRES) and h1.shape == (7, 24)


def test_tuning_center_archive_files(tmp_path, monkeypatch):
    from aegis_tpu.apps.tuning_center import _archive_files

    artist = tmp_path / "col" / "some_artist"
    artist.mkdir(parents=True)
    (artist / "take1.wav").write_bytes(b"x")
    (artist / "take2.mp3").write_bytes(b"x")
    (artist / "notes.txt").write_bytes(b"x")
    monkeypatch.setenv("AEGIS_ARCHIVE_DIR", str(tmp_path / "col"))
    found = _archive_files()
    names = {os.path.basename(p) for p in found}
    assert {"take1.wav", "take2.mp3"} <= names
    assert "notes.txt" not in names


def test_live_monitor_stream_helpers():
    """The live-monitor app's streaming loop works headlessly: the upload
    is fed in chunks and the event list grows to the finalize result."""
    import numpy as np

    from aegis_tpu.apps.live_monitor import make_transcriber, stream_in_chunks
    from aegis_tpu.tools.signal_gen import two_tone

    y = two_tone(sr=22050)
    for kind in ("v1", "poly"):
        rt = make_transcriber(kind, 22050, 0.5)
        steps = list(stream_in_chunks(rt, y, 22050, chunk_s=1.0))
        assert steps and steps[-1][0] == len(y) / 22050
        final = rt.finalize()
        assert {e["note"] for e in final} >= {55, 62}, (kind, final)
