"""TikTok profile crawler (C22): the port's copy of ``vct/serve/crawler.py``.
``python -m vct_torch.serve.crawler`` runs it.

The counterpart of ``medsos_lrcn/src/crawler.py:24-172``: read profile URLs
from ``profile_urls.txt``, open each profile, scroll to load the video grid,
extract ``/@user/video/<id>`` links, skip URLs the backend already classified
(``crawler.py:124-141`` is_url_classified), and bulk-download the rest via
the TikTok client.

Browser automation is pluggable: when Playwright is installed the reference's
flow is used (cookie injection, scroll loop, retry on the "Something went
wrong" interstitial, ``crawler.py:60-97``); otherwise a plain requests fetch
parses whatever server-rendered links exist — sufficient for testing and for
profiles that render the grid statically. The link-extraction and
classified-filter logic is pure and covered by unit tests either way.

Cookies: the reference pulls session cookies live from a local Firefox
profile via browser_cookie3 (``crawler.py:30-46``). That assumes a desktop
browser next to the crawler; this stack runs headless in containers
(build/crawler.dockerfile), so cookies come from an explicit Netscape
``cookies.txt`` (``--cookies``, ``vct_torch.serve.tiktok.load_cookies_txt``) or a
dict — a deliberate drop of the browser-profile dependency, not an omission.
"""

from __future__ import annotations

import os
import re
from typing import Iterable, List, Optional

import requests

from vct_torch.core.config import ServeConfig

__all__ = [
    "extract_video_links",
    "is_url_classified",
    "scrape_profile",
    "crawl_profiles",
    "main",
]

VIDEO_LINK_RE = re.compile(r"https?://www\.tiktok\.com/@[\w.]+/video/\d+")

# TikTok's block/interstitial page marker; both fetch paths retry through it
# (the reference's loop, crawler.py:89-97).
BLOCK_MARKER = "Something went wrong"
BLOCK_RETRIES = 5


def extract_video_links(html: str, username: Optional[str] = None) -> List[str]:
    """All /@user/video/<id> links in a profile page, de-duplicated in order."""
    from bs4 import BeautifulSoup

    soup = BeautifulSoup(html, "html.parser")
    links: List[str] = []
    for a in soup.find_all("a", href=True):
        href = a["href"]
        if href.startswith("/"):
            href = "https://www.tiktok.com" + href
        m = VIDEO_LINK_RE.match(href)
        if m and (username is None or f"@{username}/" in href):
            if href not in links:
                links.append(href)
    # also catch links embedded in scripts/JSON
    for m in VIDEO_LINK_RE.finditer(html):
        href = m.group(0)
        if (username is None or f"@{username}/" in href) and href not in links:
            links.append(href)
    return links


def is_url_classified(video_url: str, checker_url: str) -> bool:
    """Ask the backend whether the URL already has labels
    (crawler.py:124-141 / loader_data.py:555-573)."""
    try:
        response = requests.get(checker_url, params={"url": video_url}, timeout=10)
        if response.status_code == 200:
            data = response.json()
            if "url" in data and "labels" in data:
                print(f"URL {video_url} is already classified with label: {data['labels']}")
                return True
            print(f"URL {video_url} is not classified yet.")
            return False
        print(
            f"Failed to check classification status for {video_url}. "
            f"HTTP {response.status_code}: {response.text}"
        )
        return False
    except Exception as e:
        print(f"Error checking classification status for {video_url}: {e}")
        return False


def _scrape_with_playwright(profile_url: str, scrolls: int, cookies: Optional[dict]):
    from playwright.sync_api import sync_playwright  # optional dependency

    with sync_playwright() as p:
        browser = p.firefox.launch(headless=True)
        context = browser.new_context()
        if cookies:
            context.add_cookies(
                [
                    {"name": k, "value": v, "domain": ".tiktok.com", "path": "/"}
                    for k, v in cookies.items()
                ]
            )
        page = context.new_page()
        for attempt in range(BLOCK_RETRIES):  # crawler.py:89-97 retry loop
            page.goto(profile_url, wait_until="domcontentloaded")
            page.wait_for_timeout(3000)
            if BLOCK_MARKER not in page.content():
                break
            print("Something went wrong page - retrying...")
        for _ in range(scrolls):
            page.mouse.wheel(0, 10000)
            page.wait_for_timeout(1500)
        html = page.content()
        browser.close()
    return html


def scrape_profile(
    profile_url: str, scrolls: int = 5, cookies: Optional[dict] = None
) -> List[str]:
    """Returns the profile's video links."""
    username = None
    m = re.search(r"@([\w.]+)", profile_url)
    if m:
        username = m.group(1)
    try:
        html = _scrape_with_playwright(profile_url, scrolls, cookies)
    except ImportError:
        print("playwright not installed - falling back to static fetch "
              "(dynamic grids need: pip install playwright)")
        html = _static_profile_html(profile_url)
    return extract_video_links(html, username)


def _static_profile_html(profile_url: str, retries: int = BLOCK_RETRIES) -> str:
    """Plain-requests profile fetch with the same block-page retry loop the
    playwright path runs (reference crawler.py:89-97)."""
    from vct_torch.serve.tiktok import HEADERS

    html = ""
    for attempt in range(retries):
        html = requests.get(profile_url, headers=HEADERS, timeout=20).text
        if BLOCK_MARKER not in html:
            break
        print("Something went wrong page - retrying...")
    return html


def crawl_profiles(
    profile_urls: Iterable[str],
    cfg: ServeConfig,
    download: bool = True,
    cookies: Optional[dict] = None,
) -> List[str]:
    """Scrape every profile, filter classified, download the rest."""
    to_download: List[str] = []
    for profile_url in profile_urls:
        print(f"Scraping: {profile_url}")
        try:
            links = scrape_profile(profile_url, cookies=cookies)
        except Exception as e:
            # One dead profile must not discard every other profile's links
            # (the crawl is a long network-bound batch job).
            print(f"  skipping {profile_url}: {e}")
            continue
        print(f"  found {len(links)} video links")
        for link in links:
            if not is_url_classified(link, cfg.backend_checker):
                to_download.append(link)
    print(f"{len(to_download)} videos to download")
    if download and to_download:
        from vct_torch.serve.tiktok import save_tiktok_multi_urls

        os.makedirs(cfg.video_dir, exist_ok=True)
        save_tiktok_multi_urls(
            to_download, save_video=True, save_dir=cfg.video_dir, cookies=cookies
        )
    return to_download


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="TikTok profile crawler")
    parser.add_argument("--profiles", default="profile_urls.txt",
                        help="file with one profile URL per line")
    parser.add_argument("--video_dir", default=None)
    parser.add_argument("--cookies", default=None, help="Netscape cookies.txt")
    parser.add_argument(
        "--browser_cookies", default=None, metavar="BROWSER",
        help="pull live cookies from a local browser profile (the "
             "reference's browser_cookie3 flow; needs browser_cookie3 "
             "installed), e.g. firefox or chrome",
    )
    parser.add_argument("--no-download", action="store_true")
    args = parser.parse_args(argv)

    cfg = ServeConfig(
        app_stage=os.environ.get("APP_STAGE", "devel"),
        video_dir=args.video_dir or os.environ.get("VIDEO_DIR", "/tmp/vct_videos"),
    )
    cookies = None
    if args.cookies:
        from vct_torch.serve.tiktok import load_cookies_txt

        cookies = load_cookies_txt(args.cookies)
    elif args.browser_cookies:
        from vct_torch.serve.tiktok import load_browser_cookies

        cookies = load_browser_cookies(args.browser_cookies)
    with open(args.profiles) as f:
        profiles = [line.strip() for line in f if line.strip()]
    crawl_profiles(profiles, cfg, download=not args.no_download, cookies=cookies)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
