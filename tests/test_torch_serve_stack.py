"""The port's host serving modules against ``vct``'s on the CPU: the result
store, the work queue (both directions between the packages), the REST
backend (live HTTP, the same requests to both backends: the same status
codes and JSON bodies), the TikTok client (canned pages from the local stub
of ``tests/test_tiktok_fixtures.py``: the port's files, file names and
metadata CSV byte-equal to ``vct``'s) and the crawler.

Every server thread is shut down and every puller closed in a ``finally``
block, and every wait has a timeout.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib.util
import json
import os
import socket
import threading
import time
from http.server import ThreadingHTTPServer

import pytest
import requests

import test_serve
from test_tiktok_fixtures import _StubHandler
from vct.core import config as vct_config
from vct.serve import backend as vct_backend
from vct.serve import crawler as vct_crawler
from vct.serve import queue as vct_queue
from vct.serve import store as vct_store
from vct.serve import tiktok as vct_tiktok
from vct_torch.core import config
from vct_torch.serve import backend, crawler, queue, store, tiktok

pytest.importorskip("bs4")
PACKAGES = {"vct": (vct_config, vct_store, vct_queue, vct_backend, vct_tiktok, vct_crawler),
            "port": (config, store, queue, backend, tiktok, crawler)}


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@contextlib.contextmanager
def _serving(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


# ---------------------------------------------------------------------------
# the result store


def _store_ops(module, path):
    s = module.ResultStore(path)
    seen = [s.find_one("u1")]
    s.insert("u1", ["harmful", "safe"], [0.9, 0.1], "2024-01-01T00:00:00")
    seen.append(s.find_one("u1"))
    s.insert("u1", ["safe"])  # upsert, no scores
    s.insert("u2", ["a", "b"], [0.5, 0.5], "t")
    seen += [s.find_one("u1"), s.find_one("u2"), s.all()]
    return seen


def test_store_inserts_and_looks_up_as_vct(tmp_path):
    got = _store_ops(store, str(tmp_path / "db" / "port.db"))
    assert got == _store_ops(vct_store, str(tmp_path / "db" / "vct.db"))
    assert got[0] is None and got[2]["scores"] is None and len(got[-1]) == 2
    # one schema: each package reads the other's file
    assert vct_store.ResultStore(str(tmp_path / "db" / "port.db")).all() == got[-1]
    assert store.ResultStore(str(tmp_path / "db" / "vct.db")).all() == got[-1]


def test_store_takes_threaded_writers_and_readers(tmp_path):
    s = store.ResultStore(str(tmp_path / "r.db"))
    found = []

    def work(i):
        s.insert(f"u{i}", [str(i)], [float(i)], f"t{i}")
        found.append(s.find_one(f"u{i}"))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert sorted(d["url"] for d in found) == sorted(f"u{i}" for i in range(16))
    assert sorted((d["url"], d["labels"]) for d in s.all()) == sorted(
        (f"u{i}", [str(i)]) for i in range(16))


# ---------------------------------------------------------------------------
# the work queue


@pytest.mark.parametrize("push_from,pull_from", [("port", "port"), ("vct", "port"),
                                                 ("port", "vct")])
def test_queue_round_trip_between_packages(push_from, pull_from):
    port = _free_port()
    pull = PACKAGES[pull_from][2].QueuePull(host="127.0.0.1", port=port)
    pull.bind()
    received = []

    def consume():
        for msg in pull.messages():
            received.append(msg)
            if len(received) >= 2:
                pull.close()

    thread = threading.Thread(target=consume, daemon=True)
    thread.start()
    try:
        push = PACKAGES[push_from][2].QueuePush(host="127.0.0.1", port=port)
        push.send("https://example.com/v/1")
        push.send({"url": "https://example.com/v/2"})
        thread.join(timeout=10)
    finally:
        pull.close()
    assert not thread.is_alive()
    assert received[0] == "https://example.com/v/1"
    assert json.loads(received[1]) == {"url": "https://example.com/v/2"}


@pytest.mark.parametrize("name", ["vct", "port"])
def test_queue_consume_swallows_a_failing_callback(name, capsys):
    queue_module = PACKAGES[name][2]
    port = _free_port()
    pull = queue_module.QueuePull(host="127.0.0.1", port=port)
    pull.bind()
    seen = []

    def callback(msg):
        seen.append(msg)
        if msg == "bad":
            raise ValueError("boom")
        if len(seen) >= 2:
            pull.close()

    thread = threading.Thread(target=pull.consume, args=(callback,), daemon=True)
    thread.start()
    try:
        push = queue_module.QueuePush(host="127.0.0.1", port=port)
        push.send("bad")
        push.send("good")
        thread.join(timeout=10)
    finally:
        pull.close()
    assert not thread.is_alive()
    assert seen == ["bad", "good"]
    assert capsys.readouterr().out == "Error processing message 'bad': boom\n"


# ---------------------------------------------------------------------------
# the REST backend: the same requests to vct's and the port's


@pytest.fixture(scope="module")
def backends(tmp_path_factory):
    """{package: base URL} of both backends, no queue, each on its store."""
    root = tmp_path_factory.mktemp("backends")
    bases, stack = {}, contextlib.ExitStack()
    with stack:
        for name, (cfg_module, store_module, _, backend_module, _, _) in PACKAGES.items():
            cfg = cfg_module.ServeConfig(backend_host="127.0.0.1", backend_port=0,
                                         db_path=str(root / f"{name}.db"))
            server = backend_module.make_server(cfg, store=store_module.ResultStore(cfg.db_path),
                                                with_queue=False)
            stack.enter_context(_serving(server))
            bases[name] = f"http://127.0.0.1:{server.server_address[1]}"
        yield bases


def _classify(url, **extra):
    return ("POST", "/classify", {"json": {"url": url, "labels": ["safe", "harmful"],
                                           "scores": [0.75, 0.25], **extra}})


BACKEND_CASES = {
    "classify_then_lookup": [_classify("https://t/v/1", timestamp="now"),
                             ("GET", "/video_labels", {"params": {"url": "https://t/v/1"}})],
    "classify_twice_upserts": [_classify("https://t/v/2"),
                               ("POST", "/classify", {"json": {"url": "https://t/v/2",
                                                               "labels": ["other"]}}),
                               ("GET", "/video_labels", {"params": {"url": "https://t/v/2"}})],
    "lookup_missing": [("GET", "/video_labels", {"params": {"url": "https://t/v/none"}})],
    "classify_without_fields": [("POST", "/classify", {"json": {}}),
                                ("POST", "/classify", {"json": {"url": "https://t/v/3"}}),
                                ("POST", "/classify", {"json": {"labels": ["a"]}})],
    "classify_bad_json": [("POST", "/classify", {"data": "{bad"})],
    "url_parameter_missing": [("GET", "/video_labels", {}), ("GET", "/get_labels", {})],
    "unknown_routes": [("GET", "/unknown", {}), ("POST", "/video_labels", {"json": {}}),
                       ("GET", "/classify", {})],
    "get_labels_hit": [_classify("https://t/v/4"),
                       ("GET", "/get_labels", {"params": {"url": "https://t/v/4"}})],
    "get_labels_miss_without_queue": [
        ("GET", "/get_labels", {"params": {"url": "https://t/v/none"}})],
}


@pytest.mark.parametrize("case", list(BACKEND_CASES))
def test_backend_answers_as_vct(backends, case):
    replies = {}
    for name, base in backends.items():
        replies[name] = []
        for method, route, kwargs in BACKEND_CASES[case]:
            r = requests.request(method, base + route, timeout=10, **kwargs)
            replies[name].append((r.status_code, r.headers["Content-Type"], r.json()))
    assert replies["port"] == replies["vct"]
    assert {r[0] for r in replies["port"]} <= {200, 400, 404}


@pytest.mark.parametrize("worker", ["answers", "queue_down", "silent"])
def test_get_labels_enqueues_and_waits_as_vct(worker, tmp_path):
    """``/get_labels`` on a miss pushes the URL to the queue and polls the
    store: a worker that answers gives 200 and the labels, no queue 503,
    a worker that never answers 404 after the poll's timeout."""
    replies = {}
    for name, (cfg_module, store_module, queue_module, backend_module, _, _) in PACKAGES.items():
        cfg = cfg_module.ServeConfig(backend_host="127.0.0.1", backend_port=0,
                                     queue_port=_free_port(), db_path=str(tmp_path / f"{name}.db"))
        s = store_module.ResultStore(cfg.db_path)
        pull = queue_module.QueuePull(host="127.0.0.1", port=cfg.queue_port)
        got = []

        def fake_worker():
            for msg in pull.messages():
                got.append(msg)
                if worker == "answers":
                    time.sleep(0.2)
                    s.insert(msg, ["mock_label"], [1.0], "t")

        thread = threading.Thread(target=fake_worker, daemon=True)
        if worker != "queue_down":
            pull.bind()
            thread.start()
        poll_timeout = 10.0 if worker == "answers" else 1.0
        server = backend_module.make_server(cfg, store=s, poll_timeout=poll_timeout)
        try:
            with _serving(server):
                t0 = time.perf_counter()
                r = requests.get(f"http://127.0.0.1:{server.server_address[1]}/get_labels",
                                 params={"url": "https://t/v/9"}, timeout=15)
                waited = time.perf_counter() - t0
        finally:
            pull.close()
            if thread.ident is not None:
                thread.join(timeout=10)
        assert not thread.is_alive()
        assert got == ([] if worker == "queue_down" else ["https://t/v/9"])
        assert waited < poll_timeout + 4.0  # the poll gives up after its timeout
        replies[name] = (r.status_code, r.json())
    assert replies["port"] == replies["vct"]
    assert replies["port"][0] == {"answers": 200, "queue_down": 503, "silent": 404}[worker]


# ---------------------------------------------------------------------------
# the TikTok client


@pytest.fixture(scope="module")
def stub():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _StubHandler)
    with _serving(server):
        yield f"http://127.0.0.1:{server.server_port}"


@pytest.mark.parametrize("html,script_id,video_id", [
    (test_serve.SIGI_HTML, "SIGI_STATE", None),
    (test_serve.SIGI_HTML, "SIGI_STATE", "7001"),
    (test_serve.UNIVERSAL_HTML, "__UNIVERSAL_DATA_FOR_REHYDRATION__", None),
    (test_serve.UNIVERSAL_HTML, "SIGI_STATE", None),
    ("<html><script id='SIGI_STATE'>{not json</script></html>", "SIGI_STATE", None),
])
def test_tiktok_page_parsing_as_vct(html, script_id, video_id):
    got = tiktok._script_json(html, script_id)
    assert got == vct_tiktok._script_json(html, script_id)
    if got is not None:
        item = tiktok.extract_video_record(got, video_id)
        assert item == vct_tiktok.extract_video_record(got, video_id)
        assert tiktok.generate_data_row(item) == vct_tiktok.generate_data_row(item)
        assert list(tiktok.generate_data_row(item)) == vct_tiktok.METADATA_FIELDS


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


TIKTOK_CASES = {
    "sigi_state": lambda m, stub, d: m.save_tiktok(
        f"{stub}/@user/video/111", metadata_fn=os.path.join(d, "meta.csv"), save_dir=d,
        return_fns=True),
    "universal_fallback": lambda m, stub, d: m.save_tiktok(
        f"{stub}/@user2/video/222", metadata_fn=os.path.join(d, "meta.csv"), save_dir=d,
        return_fns=True),
    "slideshow": lambda m, stub, d: m.save_tiktok(
        f"{stub}/@user3/video/333", metadata_fn=os.path.join(d, "meta.csv"), save_dir=d,
        return_fns=True),
    "multi_url_loop": lambda m, stub, d: m.save_tiktok_multi_urls(
        [f"{stub}/@user/video/111", f"{stub}/@user2/video/222", f"{stub}/@user3/video/333"],
        metadata_fn=os.path.join(d, "meta.csv"), sleep=0.01, save_dir=d),
    "no_page_data": lambda m, stub, d: m.save_tiktok(
        f"{stub}/@user/profile_page_missing/1", save_dir=d, return_fns=True),
    "nothing_to_do": lambda m, stub, d: m.save_tiktok(
        f"{stub}/@user/video/111", save_video=False, save_dir=d, return_fns=True),
    "metadata_only": lambda m, stub, d: m.save_tiktok(
        f"{stub}/@user/video/111", save_video=False, metadata_fn=os.path.join(d, "meta.csv"),
        save_dir=d, return_fns=True),
}


@pytest.mark.parametrize("case", list(TIKTOK_CASES))
def test_tiktok_downloads_byte_equal_to_vct(stub, case, tmp_path, capsys):
    outs = {}
    for name, module in (("vct", vct_tiktok), ("port", tiktok)):
        d = tmp_path / name
        d.mkdir()
        fns = TIKTOK_CASES[case](module, stub, str(d))
        text = capsys.readouterr().out.replace(str(d), "<dir>")
        outs[name] = (None if fns is None else [os.path.relpath(f, d) for f in fns],
                      _tree(d), text)
    assert outs["port"] == outs["vct"]
    fns, files, _ = outs["port"]
    if case in ("sigi_state", "universal_fallback", "slideshow", "multi_url_loop"):
        assert fns and all(f in files for f in fns) and "meta.csv" in files


def test_tiktok_with_a_fake_session_as_vct(tmp_path):
    class Response:
        def __init__(self, text="", content=b""):
            self.text, self.content = text, content

    class Session:
        def get(self, url, **kwargs):
            if "tiktok.com/@" in url:
                return Response(text=test_serve.SIGI_HTML)
            return Response(content=b"FAKEVIDEO")

    trees = []
    for module in (vct_tiktok, tiktok):
        d = tmp_path / module.__name__
        d.mkdir()
        fns = module.save_tiktok("https://www.tiktok.com/@someuser/video/7001",
                                 session=Session(), save_dir=str(d), return_fns=True,
                                 metadata_fn=str(d / "meta.csv"))
        assert [os.path.basename(f) for f in fns] == ["@someuser_video_7001.mp4"]
        trees.append(_tree(d))
    assert trees[0] == trees[1]
    assert trees[1]["@someuser_video_7001.mp4"] == b"FAKEVIDEO"


def test_tiktok_cookies_as_vct(tmp_path):
    path = tmp_path / "cookies.txt"
    path.write_text("# Netscape HTTP Cookie File\n\n"
                    ".tiktok.com\tTRUE\t/\tTRUE\t0\tsessionid\tabc\n"
                    ".tiktok.com\tTRUE\t/\tFALSE\t0\ttt_csrf\txyz\n"
                    "short\tline\n")
    assert tiktok.load_cookies_txt(str(path)) == vct_tiktok.load_cookies_txt(str(path)) == {
        "sessionid": "abc", "tt_csrf": "xyz"}
    if importlib.util.find_spec("browser_cookie3") is None:
        for module in (vct_tiktok, tiktok):
            with pytest.raises(RuntimeError, match="browser_cookie3 is not installed"):
                module.load_browser_cookies()


# ---------------------------------------------------------------------------
# the crawler


@pytest.mark.parametrize("username", ["someuser", None])
def test_crawler_extracts_links_as_vct(username):
    html = test_serve.TestCrawler.PROFILE_HTML
    got = crawler.extract_video_links(html, username)
    assert got == vct_crawler.extract_video_links(html, username)
    assert ("https://www.tiktok.com/@otheruser/video/333" in got) == (username is None)


def _crawl(module, case, stub, tmp_path, monkeypatch):
    cfg_module = PACKAGES["vct" if module is vct_crawler else "port"][0]
    if case == "block_page_retry":
        _StubHandler.flaky_hits = 0
        return module.scrape_profile(f"{stub}/@flaky")
    if case == "filter_classified":
        cfg = cfg_module.ServeConfig(video_dir=str(tmp_path / "videos"), backend_base_url=stub)
        return module.crawl_profiles([f"{stub}/@user", f"{stub}/@missing"], cfg,
                                     download=False)
    if case == "is_url_classified":
        return [module.is_url_classified(f"https://www.tiktok.com/@user/video/{i}",
                                         f"{stub}/video_labels") for i in (111, 444)]
    # main's ServeConfig asks the stub whether a link is classified
    monkeypatch.setattr(module, "ServeConfig",
                        functools.partial(cfg_module.ServeConfig, backend_base_url=stub))
    _StubHandler.flaky_hits = 0
    profiles = tmp_path / "profile_urls.txt"
    profiles.write_text(f"{stub}/@flaky\n\n")
    return module.main(["--profiles", str(profiles), "--video_dir", str(tmp_path / "v"),
                        "--no-download"])


@pytest.mark.parametrize("case", ["block_page_retry", "filter_classified",
                                  "is_url_classified", "main_no_download"])
def test_crawler_as_vct(stub, case, tmp_path, capsys, monkeypatch):
    outs = {}
    for name, module in (("vct", vct_crawler), ("port", crawler)):
        result = _crawl(module, case, stub, tmp_path, monkeypatch)
        outs[name] = (result, capsys.readouterr().out)
    assert outs["port"] == outs["vct"]
    result, out = outs["port"]
    if case == "block_page_retry":
        assert out.count("Something went wrong page - retrying...") == 2
        assert [u.rsplit("/", 1)[1] for u in result] == ["555", "556"]
    if case == "filter_classified":
        assert [u.rsplit("/", 1)[1] for u in result] == ["111"]
        assert "already classified" in out
    if case == "is_url_classified":
        assert result == [False, True]
    if case == "main_no_download":
        assert result == 0 and "2 videos to download" in out


def test_serve_config_and_crawler_sources_match():
    """The port's ServeConfig is ``vct``'s, field for field and URL for URL."""
    for kwargs in ({}, {"app_stage": "prod"}, {"backend_base_url": "http://elsewhere:9000/"}):
        got, want = config.ServeConfig(**kwargs), vct_config.ServeConfig(**kwargs)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.backend_url, got.backend_checker) == (want.backend_url, want.backend_checker)
    assert crawler.VIDEO_LINK_RE.pattern == vct_crawler.VIDEO_LINK_RE.pattern
    assert (crawler.BLOCK_MARKER, crawler.BLOCK_RETRIES) == (vct_crawler.BLOCK_MARKER,
                                                             vct_crawler.BLOCK_RETRIES)
    assert tiktok.HEADERS == vct_tiktok.HEADERS
