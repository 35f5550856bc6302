"""TikTok download client (C23), the port's copy of ``vct/serve/tiktok.py`` —
an independent port of the vendored pyktok fork's active surface
(``custom_pyktok/pyktok.py:197-236,420-533``):

  * ``get_tiktok_json`` — fetch the page and parse the ``SIGI_STATE`` JSON
    blob; ``alt_get_tiktok_json`` falls back to
    ``__UNIVERSAL_DATA_FOR_REHYDRATION__``
  * ``save_tiktok`` — download the video (or every slide of an image post)
    named ``<user>_video_<id>.mp4`` — the filename convention the inference
    loader's URL reconstruction depends on (``loader_data.py:546-553``)
  * ``save_tiktok_multi_urls`` — URL loop with randomized sleep
  * ``generate_data_row`` — the 22-field metadata record per video

Session cookies come from an explicit cookie dict or a Netscape cookies.txt
file (the reference pulls live browser cookies via browser_cookie3, which is
not available in a headless service container — pass ``cookie_file`` /
``cookies`` instead).
"""

from __future__ import annotations

import json
import os
import random
import re
import time
from typing import Dict, Iterable, List, Optional

import requests

__all__ = [
    "get_tiktok_json",
    "alt_get_tiktok_json",
    "extract_video_record",
    "generate_data_row",
    "save_tiktok",
    "save_tiktok_multi_urls",
    "load_cookies_txt",
    "load_browser_cookies",
]

HEADERS = {
    "User-Agent": (
        "Mozilla/5.0 (Windows NT 10.0; Win64; x64; rv:109.0) "
        "Gecko/20100101 Firefox/116.0"
    ),
    "Accept": "text/html,application/xhtml+xml,application/xml;q=0.9,*/*;q=0.8",
    "Accept-Language": "en-US,en;q=0.5",
}

URL_RE = re.compile(r"@[\w.]+/video/\d+")

METADATA_FIELDS = [
    "video_id", "video_timestamp", "video_duration", "video_locationcreated",
    "video_diggcount", "video_sharecount", "video_commentcount",
    "video_playcount", "video_description", "video_is_ad", "video_stickers",
    "author_username", "author_name", "author_followercount",
    "author_followingcount", "author_heartcount", "author_videocount",
    "author_diggcount", "author_verified", "poi_name", "poi_address",
    "poi_city",
]


def load_cookies_txt(path: str) -> Dict[str, str]:
    """Parse a Netscape cookies.txt into a dict."""
    cookies = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 7:
                cookies[parts[5]] = parts[6]
    return cookies


def load_browser_cookies(browser: str = "firefox",
                         domain: str = ".tiktok.com") -> Dict[str, str]:
    """Best-effort live browser-cookie pull (the reference's
    browser_cookie3 flow, ``crawler.py:30-46``). Optional: only works where
    a desktop browser profile exists AND browser_cookie3 is installed;
    headless deployments use ``load_cookies_txt`` instead (see the crawler
    module docstring for the rationale)."""
    try:
        import browser_cookie3
    except ImportError as e:
        raise RuntimeError(
            "browser_cookie3 is not installed; pass a cookies.txt "
            "(load_cookies_txt) instead"
        ) from e
    jar = getattr(browser_cookie3, browser)(domain_name=domain)
    return {c.name: c.value for c in jar}


def _fetch(video_url: str, cookies: Optional[dict], session: Optional[requests.Session]):
    sess = session or requests
    return sess.get(video_url, headers=HEADERS, cookies=cookies or {}, timeout=20)


def _script_json(html: str, script_id: str) -> Optional[dict]:
    from bs4 import BeautifulSoup

    soup = BeautifulSoup(html, "html.parser")
    tag = soup.find("script", attrs={"id": script_id})
    if tag is None or tag.string is None:
        return None
    try:
        return json.loads(tag.string)
    except json.JSONDecodeError:
        return None


def get_tiktok_json(video_url: str, cookies=None, session=None) -> Optional[dict]:
    resp = _fetch(video_url, cookies, session)
    return _script_json(resp.text, "SIGI_STATE")


def alt_get_tiktok_json(video_url: str, cookies=None, session=None) -> Optional[dict]:
    resp = _fetch(video_url, cookies, session)
    data = _script_json(resp.text, "__UNIVERSAL_DATA_FOR_REHYDRATION__")
    if data is None:
        print(
            "TikTok returned no parseable page data (transient upstream "
            "issue); retry later."
        )
    return data


def extract_video_record(
    tt_json: dict, video_id: Optional[str] = None
) -> Optional[dict]:
    """Normalize SIGI_STATE or UNIVERSAL_DATA into one item record.

    ItemModule can list several items (pinned/related videos); when the
    requested ``video_id`` is known, return THAT item — the first key is not
    guaranteed to be the page's own video."""
    if "ItemModule" in tt_json:
        items = tt_json["ItemModule"]
        if not items:
            return None
        if video_id is not None and video_id in items:
            return items[video_id]
        return items[list(items.keys())[0]]
    scope = tt_json.get("__DEFAULT_SCOPE__", {})
    detail = scope.get("webapp.video-detail", {})
    return detail.get("itemInfo", {}).get("itemStruct")


def generate_data_row(item: dict) -> dict:
    """The 22-field metadata record (custom_pyktok/pyktok.py:generate_data_row)."""
    row = {f: None for f in METADATA_FIELDS}
    stats = item.get("stats", {})
    author = item.get("author", {})
    author_stats = item.get("authorStats", {})
    poi = item.get("poi", {})
    row.update({
        "video_id": item.get("id"),
        "video_timestamp": item.get("createTime"),
        "video_duration": item.get("video", {}).get("duration"),
        "video_locationcreated": item.get("locationCreated"),
        "video_diggcount": stats.get("diggCount"),
        "video_sharecount": stats.get("shareCount"),
        "video_commentcount": stats.get("commentCount"),
        "video_playcount": stats.get("playCount"),
        "video_description": item.get("desc"),
        "video_is_ad": item.get("isAd", False),
        "video_stickers": json.dumps(
            [s.get("stickerText") for s in item.get("stickersOnItem", [])]
        ) if item.get("stickersOnItem") else None,
        "author_username": author.get("uniqueId") if isinstance(author, dict) else author,
        "author_name": author.get("nickname") if isinstance(author, dict) else None,
        "author_followercount": author_stats.get("followerCount"),
        "author_followingcount": author_stats.get("followingCount"),
        "author_heartcount": author_stats.get("heartCount"),
        "author_videocount": author_stats.get("videoCount"),
        "author_diggcount": author_stats.get("diggCount"),
        "author_verified": author.get("verified") if isinstance(author, dict) else None,
        "poi_name": poi.get("name"),
        "poi_address": poi.get("address"),
        "poi_city": poi.get("city"),
    })
    return row


def save_tiktok(
    video_url: str,
    save_video: bool = True,
    metadata_fn: str = "",
    cookies=None,
    session=None,
    save_dir: str = "",
    return_fns: bool = False,
):
    """Download one video/slideshow + optionally append a metadata CSV row."""
    if not save_video and not metadata_fn:
        print("Nothing to do: save_video is False and no metadata_fn given.")
        return None
    tt_json = get_tiktok_json(video_url, cookies, session)
    if tt_json is None:
        tt_json = alt_get_tiktok_json(video_url, cookies, session)
    if tt_json is None:
        print(f"Could not extract data for {video_url}")
        return None
    id_match = re.search(r"/video/(\d+)", video_url)
    item = extract_video_record(tt_json, id_match.group(1) if id_match else None)
    if item is None:
        print(f"No video record in page data for {video_url}")
        return None

    saved = []
    if save_video:
        match = URL_RE.findall(video_url)
        stem = match[0].replace("/", "_") if match else f"video_{item.get('id')}"
        dl_headers = dict(HEADERS, referer="https://www.tiktok.com/")
        sess = session or requests
        if "imagePost" in item:
            for i, slide in enumerate(item["imagePost"].get("images", []), start=1):
                slide_url = slide["imageURL"]["urlList"][0]
                fn = os.path.join(save_dir, f"{stem}_slide_{i}.jpeg")
                content = sess.get(
                    slide_url, allow_redirects=True, headers=dl_headers,
                    cookies=cookies or {}, timeout=60,
                ).content
                with open(fn, "wb") as f:
                    f.write(content)
                saved.append(fn)
        else:
            dl_url = item.get("video", {}).get("downloadAddr") or item.get(
                "video", {}
            ).get("playAddr")
            if not dl_url:
                print(f"No download address for {video_url}")
                return None
            fn = os.path.join(save_dir, f"{stem}.mp4")
            content = sess.get(
                dl_url, allow_redirects=True, headers=dl_headers,
                cookies=cookies or {}, timeout=60,
            ).content
            with open(fn, "wb") as f:
                f.write(content)
            saved.append(fn)
            print(f"Saved video\n{dl_url}\nto\n{fn}")

    if metadata_fn:
        import csv

        row = generate_data_row(item)
        exists = os.path.exists(metadata_fn)
        with open(metadata_fn, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=METADATA_FIELDS)
            if not exists:
                writer.writeheader()
            writer.writerow(row)
    return saved if return_fns else None


def save_tiktok_multi_urls(
    video_urls: Iterable[str],
    save_video: bool = True,
    metadata_fn: str = "",
    sleep: float = 4,
    cookies=None,
    session=None,
    save_dir: str = "",
) -> List[str]:
    """URL loop with randomized inter-request sleep
    (custom_pyktok/pyktok.py save_tiktok_multi_urls)."""
    saved_all = []
    urls = list(video_urls)
    for i, url in enumerate(urls):
        fns = save_tiktok(
            url, save_video=save_video, metadata_fn=metadata_fn,
            cookies=cookies, session=session, save_dir=save_dir,
            return_fns=True,
        )
        if fns:
            saved_all.extend(fns)
        if i < len(urls) - 1:
            time.sleep(random.uniform(sleep * 0.5, sleep * 1.5))
    return saved_all
