"""Dataset acquisition: download-by-name with checksums, cache, extraction.

Functional mirror of the reference's dataset download path
(`third_party/recbole/data/dataset/dataset.py:214-254` `_get_download_url`/
`_download` + `utils/url.py` download_url/extract_zip/rename_atomic_files):
`acquire_dataset(name, data_dir)` makes `<data_dir>/<name>/<name>.inter`
(and friends) exist — returning immediately when the files are already on
disk (the cache/local-fallback path), otherwise downloading the archive
from the registry, verifying an optional sha256, extracting, and renaming
the atomic files to the canonical dataset name.

Improvements over the reference: atomic tmp+rename writes (a preempted
download never leaves a torn archive), sha256 verification, no interactive
"Will you proceed?" prompt (callers gate size themselves).

The port's own copy of `recbox_tpu/data/acquire.py`, with its
multi-process guard (:305-357): under several `torch.distributed`
processes rank 0 downloads and extracts while every rank waits at the
barrier (`parallel.mesh.barrier`), on a shared file system.

The URL registry mirrors the reference's
`properties/dataset/url.yaml`/`kg_url.yaml` name->archive mapping for the
RecSysDatasets processed-atomic-file mirrors; entries are registered
lazily so custom mirrors drop in with `register_dataset_url`.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import tarfile
import urllib.request
import zipfile
from typing import Dict, Optional

logger = logging.getLogger("recbox_tpu_torch")

__all__ = ["DATASET_URLS", "register_dataset_url", "download_url",
           "extract_archive", "rename_atomic_files", "acquire_dataset"]

_MIRROR = "https://recbole.s3-accelerate.amazonaws.com/"

# Full name -> archive map mirroring the reference registry
# (`third_party/recbole/properties/dataset/url.yaml`, 138 entries;
# suffixes relative to the mirror root). Spellings are the
# reference's; extend via register_dataset_url for custom mirrors.
_URL_SUFFIXES = {
    "adult": "ProcessedDatasets/Adult/adult.zip",
    "alibaba-ifashion": "ProcessedDatasets/Alibaba-iFashion/Alibaba-iFashion.zip",
    "aliec": "ProcessedDatasets/AliEC/AliEC.zip",
    "amazon-all-beauty-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_All_Beauty.zip",
    "amazon-appliances-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Appliances.zip",
    "amazon-apps-for-android": "ProcessedDatasets/Amazon_ratings/Amazon_Apps_for_Android.zip",
    "amazon-arts-crafts-sewing-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Arts_Crafts_and_Sewing.zip",
    "amazon-automotive": "ProcessedDatasets/Amazon_ratings/Amazon_Automotive.zip",
    "amazon-automotive-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Automotive.zip",
    "amazon-baby": "ProcessedDatasets/Amazon_ratings/Amazon_Baby.zip",
    "amazon-beauty": "ProcessedDatasets/Amazon_ratings/Amazon_Beauty.zip",
    "amazon-books": "ProcessedDatasets/Amazon_ratings/Amazon_Books.zip",
    "amazon-books-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Books.zip",
    "amazon-cds-vinyl": "ProcessedDatasets/Amazon_ratings/Amazon_CDs_and_Vinyl.zip",
    "amazon-cds-vinyl-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_CDs_and_Vinyl.zip",
    "amazon-cell-phones-accessories": "ProcessedDatasets/Amazon_ratings/Amazon_Cell_Phones_and_Accessories.zip",
    "amazon-cell-phones-accessories-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Cell_Phones_and_Accessories.zip",
    "amazon-clothing-shoes-jewelry": "ProcessedDatasets/Amazon_ratings/Amazon_Clothing_Shoes_and_Jewelry.zip",
    "amazon-clothing-shoes-jewelry-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Clothing_Shoes_and_Jewelry.zip",
    "amazon-digital-music": "ProcessedDatasets/Amazon_ratings/Amazon_Digital_Music.zip",
    "amazon-digital-music-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Digital_Music.zip",
    "amazon-electronics": "ProcessedDatasets/Amazon_ratings/Amazon_Electronics.zip",
    "amazon-electronics-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Electronics.zip",
    "amazon-fashion-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Fashion.zip",
    "amazon-gift-cards-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Gift_Cards.zip",
    "amazon-grocery-gourmet-food": "ProcessedDatasets/Amazon_ratings/Amazon_Grocery_and_Gourmet_Food.zip",
    "amazon-grocery-gourmet-food-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Grocery_and_Gourmet_Food.zip",
    "amazon-health-personal-care": "ProcessedDatasets/Amazon_ratings/Amazon_Health_and_Personal_Care.zip",
    "amazon-home-kitchen": "ProcessedDatasets/Amazon_ratings/Amazon_Home_and_Kitchen.zip",
    "amazon-home-kitchen-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Home_and_Kitchen.zip",
    "amazon-industrial-scientific-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Industrial_and_Scientific.zip",
    "amazon-instant-video": "ProcessedDatasets/Amazon_ratings/Amazon_Instant_Video.zip",
    "amazon-kindle-store": "ProcessedDatasets/Amazon_ratings/Amazon_Kindle_Store.zip",
    "amazon-kindle-store-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Kindle_Store.zip",
    "amazon-luxury-beauty-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Luxury_Beauty.zip",
    "amazon-magazine-subscriptions-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Magazine_Subscriptions.zip",
    "amazon-movies-tv": "ProcessedDatasets/Amazon_ratings/Amazon_Movies_and_TV.zip",
    "amazon-movies-tv-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Movies_and_TV.zip",
    "amazon-musical-instruments": "ProcessedDatasets/Amazon_ratings/Amazon_Musical_Instruments.zip",
    "amazon-musical-instruments-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Musical_Instruments.zip",
    "amazon-office-products": "ProcessedDatasets/Amazon_ratings/Amazon_Office_Products.zip",
    "amazon-office-products-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Office_Products.zip",
    "amazon-patio-lawn-garden": "ProcessedDatasets/Amazon_ratings/Amazon_Patio_Lawn_and_Garden.zip",
    "amazon-patio-lawn-garden-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Patio_Lawn_and_Garden.zip",
    "amazon-pet-supplies": "ProcessedDatasets/Amazon_ratings/Amazon_Pet_Supplies.zip",
    "amazon-pet-supplies-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Pet_Supplies.zip",
    "amazon-prime-pantry-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Prime_Pantry.zip",
    "amazon-software-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Software.zip",
    "amazon-sports-outdoors": "ProcessedDatasets/Amazon_ratings/Amazon_Sports_and_Outdoors.zip",
    "amazon-sports-outdoors-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Sports_and_Outdoors.zip",
    "amazon-tools-home-improvement": "ProcessedDatasets/Amazon_ratings/Amazon_Tools_and_Home_Improvement.zip",
    "amazon-tools-home-improvement-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Tools_and_Home_Improvement.zip",
    "amazon-toys-games": "ProcessedDatasets/Amazon_ratings/Amazon_Toys_and_Games.zip",
    "amazon-toys-games-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Toys_and_Games.zip",
    "amazon-video-games": "ProcessedDatasets/Amazon_ratings/Amazon_Video_Games.zip",
    "amazon-video-games-18": "ProcessedDatasets/Amazon_ratings/Amazon2018/Amazon_Video_Games.zip",
    "anime": "ProcessedDatasets/Anime/anime.zip",
    "avazu": "ProcessedDatasets/Avazu/avazu.zip",
    "beeradvocate": "ProcessedDatasets/BeerAdvocate/BeerAdvocate.zip",
    "behance": "ProcessedDatasets/Behance/Behance.zip",
    "book-crossing": "ProcessedDatasets/Book-Crossing/book-crossing.zip",
    "criteo": "ProcessedDatasets/Criteo/criteo.zip",
    "dianping": "ProcessedDatasets/DianPing/DianPing.zip",
    "diginetica-merged": "ProcessedDatasets/DIGINETICA/merged/diginetica.zip",
    "diginetica-not-merged": "ProcessedDatasets/DIGINETICA/not_merged/diginetica.zip",
    "diginetica-session": "ProcessedDatasets/DIGINETICA/session/diginetica_session.zip",
    "douban": "ProcessedDatasets/Douban/douban.zip",
    "endoMondo": "ProcessedDatasets/EndoMondo/EndoMondo.zip",
    "epinions": "ProcessedDatasets/Epinions/epinions.zip",
    "food": "ProcessedDatasets/Food/Food.zip",
    "foursquare-nyc-merged": "ProcessedDatasets/Foursquare/merged/foursquare_NYC.zip",
    "foursquare-nyc-not-merged": "ProcessedDatasets/Foursquare/not_merged/foursquare_NYC.zip",
    "foursquare-tky-merged": "ProcessedDatasets/Foursquare/merged/foursquare_TKY.zip",
    "foursquare-tky-not-merged": "ProcessedDatasets/Foursquare/not_merged/foursquare_TKY.zip",
    "goodreads": "ProcessedDatasets/GoodReads/GoodReads.zip",
    "gowalla-merged": "ProcessedDatasets/Gowalla/merged/gowalla.zip",
    "gowalla-not-merged": "ProcessedDatasets/Gowalla/not_merged/gowalla.zip",
    "ipinyou-click-merged": "ProcessedDatasets/iPinYou/merged/ipinyou-click.zip",
    "ipinyou-click-not-merged": "ProcessedDatasets/iPinYou/not_merged/ipinyou-click.zip",
    "ipinyou-view-merged": "ProcessedDatasets/iPinYou/merged/ipinyou-view.zip",
    "ipinyou-view-not-merged": "ProcessedDatasets/iPinYou/not_merged/ipinyou-view.zip",
    "jester": "ProcessedDatasets/Jester/jester.zip",
    "kdd2010-algebra2006-2007": "ProcessedDatasets/KDD2010/KDD2010-algebra2006_2007.zip",
    "kdd2010-algebra2008-2009": "ProcessedDatasets/KDD2010/KDD2010-algebra2008_2009.zip",
    "kdd2010-bridge-to-algebra2006-2007": "ProcessedDatasets/KDD2010/KDD2010-bridge-to-algebra2006_2007.zip",
    "kgrec-music": "ProcessedDatasets/KGRec/KGRec-music.zip",
    "kgrec-sound": "ProcessedDatasets/KGRec/KGRec-sound.zip",
    "lastfm": "ProcessedDatasets/LastFM/lastfm.zip",
    "lfm1b-albums-merged": "ProcessedDatasets/LFM-1b/merged/lfm1b-albums.zip",
    "lfm1b-albums-not-merged": "ProcessedDatasets/LFM-1b/not_merged/lfm1b-albums.zip",
    "lfm1b-artists-merged": "ProcessedDatasets/LFM-1b/merged/lfm1b-artists.zip",
    "lfm1b-artists-not-merged": "ProcessedDatasets/LFM-1b/not_merged/lfm1b-artists.zip",
    "lfm1b-tracks-merged": "ProcessedDatasets/LFM-1b/merged/lfm1b-tracks.zip",
    "lfm1b-tracks-not-merged": "ProcessedDatasets/LFM-1b/not_merged/lfm1b-tracks.zip",
    "mind-large-dev": "ProcessedDatasets/MIND/mind_large_dev.zip",
    "mind-large-train": "ProcessedDatasets/MIND/mind_large_train.zip",
    "mind-small-dev": "ProcessedDatasets/MIND/mind_small_dev.zip",
    "mind-small-train": "ProcessedDatasets/MIND/mind_small_train.zip",
    "ml-100k": "ProcessedDatasets/MovieLens/ml-100k.zip",
    "ml-10m": "ProcessedDatasets/MovieLens/ml-10m.zip",
    "ml-1m": "ProcessedDatasets/MovieLens/ml-1m.zip",
    "ml-20m": "ProcessedDatasets/MovieLens/ml-20m.zip",
    "modcloth": "ProcessedDatasets/ModCloth/ModCloth.zip",
    "music4all-onion": "ProcessedDatasets/Music4All-Onion/music4all-onion.zip",
    "netflix": "ProcessedDatasets/Netflix/netflix.zip",
    "nowplaying-session": "ProcessedDatasets/Nowplaying/session/nowplaying_session.zip",
    "phishing-website": "ProcessedDatasets/Phishing-websites/phishing-website.zip",
    "pinterest": "ProcessedDatasets/Pinterest/pinterest.zip",
    "ratebeer": "ProcessedDatasets/RateBeer/RateBeer.zip",
    "renttherunway": "ProcessedDatasets/RentTheRunway/RentTheRunway.zip",
    "retailrocket-addtocart-merged": "ProcessedDatasets/Retailrocket/merged/retailrocket-addtocart.zip",
    "retailrocket-addtocart-not-merged": "ProcessedDatasets/Retailrocket/not-merged/retailrocket-addtocart.zip",
    "retailrocket-transaction-merged": "ProcessedDatasets/Retailrocket/merged/retailrocket-transaction.zip",
    "retailrocket-transaction-not-merged": "ProcessedDatasets/Retailrocket/not-merged/retailrocket-transaction.zip",
    "retailrocket-view-merged": "ProcessedDatasets/Retailrocket/merged/retailrocket-view.zip",
    "retailrocket-view-not-merged": "ProcessedDatasets/Retailrocket/not-merged/retailrocket-view.zip",
    "steam-merged": "ProcessedDatasets/Steam/merged/steam.zip",
    "steam-not-merged": "ProcessedDatasets/Steam/not-merged/steam.zip",
    "ta-feng-merged": "ProcessedDatasets/Ta-Feng/merged/ta-feng.zip",
    "ta-feng-not-merged": "ProcessedDatasets/Ta-Feng/not-merged/ta-feng.zip",
    "tmall-buy-merged": "ProcessedDatasets/Tmall/merged/tmall-buy.zip",
    "tmall-buy-not-merged": "ProcessedDatasets/Tmall/not_merged/tmall-buy.zip",
    "tmall-click-merged": "ProcessedDatasets/Tmall/merged/tmall-click.zip",
    "tmall-click-not-merged": "ProcessedDatasets/Tmall/not_merged/tmall-click.zip",
    "tmall-session": "ProcessedDatasets/Tmall/session/tmall_session.zip",
    "twitch-100k": "ProcessedDatasets/Twitch/Twitch-100k/Twitch-100k.zip",
    "twitch-full": "ProcessedDatasets/Twitch/Twitch-full/Twitch-full.zip",
    "yahoo-music": "ProcessedDatasets/Yahoo-Music/yahoo-music.zip",
    "yelp": "ProcessedDatasets/Yelp/yelp.zip",
    "yelp-2018": "ProcessedDatasets/Yelp/yelp2018.zip",
    "yelp-2020": "ProcessedDatasets/Yelp/yelp.zip",
    "yelp-2021": "ProcessedDatasets/Yelp/yelp2021.zip",
    "yelp-2022": "ProcessedDatasets/Yelp/yelp2022.zip",
    "yelp-full": "ProcessedDatasets/Yelp/yelp-full.zip",
    "yoochoose-buys-merged": "ProcessedDatasets/YOOCHOOSE/merged/yoochoose-buys.zip",
    "yoochoose-buys-not-merged": "ProcessedDatasets/YOOCHOOSE/not-merged/yoochoose-buys.zip",
    "yoochoose-clicks-merged": "ProcessedDatasets/YOOCHOOSE/merged/yoochoose-clicks.zip",
    "yoochoose-clicks-not-merged": "ProcessedDatasets/YOOCHOOSE/not-merged/yoochoose-clicks.zip",
}

# KG-enriched variants (`kg_url.yaml`): <name>-kg resolves to the
# knowledge-graph archive of the SAME dataset name.
_KG_URL_SUFFIXES = {
    "amazon-books-kg": "KGDatasets/Amazon-book-KG.zip",
    "lfm1b-albums-merged-kg": "KGDatasets/LFM-1b-KG.zip",
    "lfm1b-albums-not-merged-kg": "KGDatasets/LFM-1b-KG.zip",
    "lfm1b-artists-merged-kg": "KGDatasets/LFM-1b-KG.zip",
    "lfm1b-artists-not-merged-kg": "KGDatasets/LFM-1b-KG.zip",
    "lfm1b-tracks-merged-kg": "KGDatasets/LFM-1b-KG.zip",
    "lfm1b-tracks-not-merged-kg": "KGDatasets/LFM-1b-KG.zip",
    "ml-100k-kg": "KGDatasets/MovieLens-KG.zip",
    "ml-10m-kg": "KGDatasets/MovieLens-KG.zip",
    "ml-1m-kg": "KGDatasets/MovieLens-KG.zip",
    "ml-20m-kg": "KGDatasets/MovieLens-KG.zip",
}

# name -> archive url: the COMPLETE reference registry (url.yaml 138
# entries + kg_url.yaml 11 as "<name>-kg"), so every BASELINE.md row and
# every recbole benchmark name resolves without hand-written glue.
DATASET_URLS: Dict[str, str] = {
    name: _MIRROR + suffix
    for name, suffix in {**_URL_SUFFIXES, **_KG_URL_SUFFIXES}.items()
}

# convenience aliases: the bare names BASELINE.md / common papers use for
# datasets the registry only carries as -merged/-not-merged variants
# (merged = duplicate user-item rows collapsed, the usual benchmark form)
for _alias, _target in {
    "gowalla": "gowalla-merged",
    "steam": "steam-merged",
    "diginetica": "diginetica-merged",
    "foursquare-nyc": "foursquare-nyc-merged",
    "foursquare-tky": "foursquare-tky-merged",
    "tmall-buy": "tmall-buy-merged",
    "tmall-click": "tmall-click-merged",
}.items():
    DATASET_URLS[_alias] = DATASET_URLS[_target]

# optional sha256 pins (filled in as archives are first fetched/verified)
DATASET_CHECKSUMS: Dict[str, str] = {}


def register_dataset_url(name: str, url: str,
                         sha256: Optional[str] = None) -> None:
    DATASET_URLS[name] = url
    if sha256:
        DATASET_CHECKSUMS[name] = sha256


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download_url(url: str, folder: str,
                 checksum: Optional[str] = None) -> str:
    """Fetch ``url`` into ``folder`` (atomic tmp+rename, sha256-verified).

    Already-present files short-circuit (after checksum re-verification
    when one is pinned) — the cache behavior of `utils/url.py:53-58`.
    """
    os.makedirs(folder, exist_ok=True)
    filename = url.rpartition("/")[2].split("?")[0]
    path = os.path.join(folder, filename)
    if os.path.exists(path):
        if checksum and _sha256(path) != checksum:
            logger.warning("cached %s fails checksum; re-downloading", path)
            os.remove(path)
        else:
            logger.info("using cached %s", path)
            return path
    logger.info("downloading %s", url)
    tmp = path + ".part"
    # bounded: a stalled mirror must fail loudly, not wedge the run
    with urllib.request.urlopen(url, timeout=60) as resp, \
            open(tmp, "wb") as out:
        shutil.copyfileobj(resp, out, length=1 << 20)
        out.flush()
        os.fsync(out.fileno())
    if checksum:
        got = _sha256(tmp)
        if got != checksum:
            os.remove(tmp)
            raise IOError(f"checksum mismatch for {url}: "
                          f"expected {checksum}, got {got}")
    os.replace(tmp, path)
    return path


def extract_archive(path: str, folder: str) -> None:
    """Unpack .zip / .tar.gz / .tgz into ``folder``."""
    logger.info("extracting %s", path)
    if path.endswith(".zip"):
        with zipfile.ZipFile(path, "r") as zf:
            zf.extractall(folder)
    elif path.endswith((".tar.gz", ".tgz", ".tar")):
        with tarfile.open(path, "r:*") as tf:
            # filter='data' rejects ../ traversal, absolute paths, links
            # outside the tree (tarfile does NOT sanitize by default)
            tf.extractall(folder, filter="data")
    else:
        raise NotImplementedError(f"archive format of {path!r}")


def rename_atomic_files(folder: str, old_base: str, new_base: str) -> None:
    """Move every atomic file (possibly nested one archive directory deep,
    possibly under the archive's own basename) to
    `<folder>/<new_base>.<ext>` (`utils/url.py:100-120` analog)."""
    del old_base  # any basename is renamed; the archive name is irrelevant
    for root, _dirs, files in os.walk(folder):
        for f in files:
            ext = os.path.splitext(f)[1]
            if ext not in (".inter", ".user", ".item", ".kg", ".link"):
                continue
            src = os.path.join(root, f)
            dst = os.path.join(folder, new_base + ext)
            if os.path.abspath(src) != os.path.abspath(dst):
                os.replace(src, dst)


def _barrier() -> None:
    from recbox_tpu_torch.parallel.mesh import barrier
    barrier()


def acquire_dataset(name: str, data_dir: str,
                    url: Optional[str] = None,
                    checksum: Optional[str] = None) -> str:
    """Ensure `<data_dir>/<name>/<name>.inter` exists; return that folder.

    Local-first: existing atomic files are used as-is (no network touch),
    so pre-staged snapshots work in air-gapped environments. Under several
    processes only rank 0 downloads; everyone else waits at the barrier
    (`dataset.py:252-254`)."""
    from recbox_tpu_torch.parallel.mesh import rank, world_size
    folder = os.path.join(data_dir, name)
    inter = os.path.join(folder, f"{name}.inter")
    multi = world_size() > 1
    if os.path.exists(inter) and not multi:
        return folder
    # rank 0 decides and downloads, EVERY rank waits at the barrier: a
    # copy cached on some hosts only must not leave the others waiting
    if not multi or rank() == 0:
        if not os.path.exists(inter):
            url = url or DATASET_URLS.get(name)
            if url is None:
                raise KeyError(
                    f"no download url registered for dataset {name!r} and "
                    f"{inter} does not exist; register one with "
                    "register_dataset_url(name, url) or stage the files "
                    "locally")
            checksum = checksum or DATASET_CHECKSUMS.get(name)
            archive = download_url(url, folder, checksum=checksum)
            extract_archive(archive, folder)
            old_base = os.path.splitext(os.path.basename(archive))[0]
            rename_atomic_files(folder, old_base, name)
            if not os.path.exists(inter):
                raise FileNotFoundError(
                    f"archive {archive} did not contain {name}.inter")
    if multi:
        _barrier()
        if not os.path.exists(inter):
            raise FileNotFoundError(
                f"{inter} missing after rank-0 download — multi-process "
                "acquisition needs a shared filesystem (or pre-staged "
                "files on every host)")
    return folder
