"""TPC-DS table generator (dsdgen-shaped, vectorized numpy, deterministic).

All 24 tables of the TPC-DS schema at any scale factor. Cardinalities follow
the spec's SF scaling (facts scale linearly, dimensions with the spec's
sub-linear steps, date/time dims are fixed); value domains cover everything
the 99 queries filter on: d_year 1998-2002 with moy/dom/qoy/week_seq chains,
the ten item categories with class/brand/manufact hierarchies, the real
cd_gender x cd_marital_status x cd_education_status cross product,
hd_buy_potential bands, ca_state/ca_gmt_offset/ca_county geography,
promotion channel flags, and returns tables generated as samples of their
sales fact (so ticket/order-number join chains in q17/q25/q29/q64 are
non-vacuous). Monetary columns are float64 (the "useDoubleForDecimal"
columnar-benchmark configuration), matching the TPC-H generator.

Copied from ``spark_rapids_tpu/tpcds/datagen.py``: the same tables, the same
random draws in the same order, so a seed gives the same values in both
packages. Each table is a ``HostBatch`` built with numpy (the machine the
port runs on has no pyarrow); a value-free Arrow type becomes the matching
``HostColumn`` (int64 → LONG, float64 → DOUBLE, date32 → DATE, strings →
STRING). Parquet output (``write_tables``) is left out.

Reference anchor: the reference has no in-tree TPC-DS generator; its
benchmark shape is integration_tests/.../mortgage/Benchmarks.scala. This is
the engine's own north-star rig (BASELINE.md).
"""
from __future__ import annotations

from datetime import date, timedelta
from typing import Callable, Dict, List

import numpy as np

from ..columnar.host import HostBatch, HostColumn, string_column
from ..types import BOOLEAN, DATE, DOUBLE, INT, LONG, Schema, StructField

EPOCH = date(1970, 1, 1)


def _days(y: int, m: int, d: int) -> int:
    return (date(y, m, d) - EPOCH).days


# date_dim covers 1997..2003 — every query predicate lands in 1998-2002
DATE_LO = _days(1997, 1, 1)
DATE_HI = _days(2003, 12, 31)
N_DATES = DATE_HI - DATE_LO + 1
# d_date_sk is dsdgen's julian-day-shaped dense surrogate
SK_BASE = 2450000

CATEGORIES = [
    "Books", "Children", "Electronics", "Home", "Jewelry",
    "Men", "Music", "Shoes", "Sports", "Women",
]
CLASSES_PER_CAT = 8
COLORS = [
    "white", "black", "red", "blue", "green", "yellow", "purple", "brown",
    "pink", "orange", "gray", "cream", "navy", "khaki", "salmon", "beige",
    "maroon", "olive", "turquoise", "azure", "chocolate", "coral", "ivory",
    "linen", "plum", "tan", "violet", "wheat", "snow", "misty", "powder",
    "honeydew", "floral", "deep", "light", "cornflower", "midnight", "cyan",
    "papaya", "frosted", "forest", "ghost", "pale", "peach", "metallic",
    "burnished", "spring", "sky", "steel", "seashell",
]
SIZES = ["small", "medium", "large", "extra large", "economy", "N/A", "petite"]
UNITS = [
    "Each", "Dozen", "Case", "Pallet", "Gross", "Box", "Bunch", "Carton",
    "Cup", "Dram", "Gram", "Lb", "Oz", "Ounce", "Pound", "Tbl", "Ton", "Tsp",
    "N/A", "Unknown",
]
GENDERS = ["M", "F"]
MARITAL = ["M", "S", "D", "W", "U"]
EDUCATION = [
    "Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
    "Advanced Degree", "Unknown",
]
CREDIT = ["Low Risk", "High Risk", "Good", "Unknown"]
BUY_POTENTIAL = [">10000", "501-1000", "Unknown", "0-500", "1001-5000",
                 "5001-10000"]
STATES = [
    "AL", "AR", "AZ", "CA", "CO", "CT", "FL", "GA", "IA", "IL", "IN", "KS",
    "KY", "LA", "MA", "MD", "MI", "MN", "MO", "MS", "NC", "ND", "NE", "NJ",
    "NM", "NY", "OH", "OK", "OR", "PA", "SC", "SD", "TN", "TX", "UT", "VA",
    "WA", "WI", "WV",
]
COUNTIES = [
    "Ziebach County", "Williamson County", "Walker County", "Salem County",
    "Raleigh County", "Oglethorpe County", "Mobile County", "Luce County",
    "Huron County", "Franklin Parish", "Fairfield County", "Dauphin County",
    "Bronx County", "Barrow County", "Arthur County",
]
CITIES = [
    "Midway", "Fairview", "Oak Grove", "Five Points", "Centerville",
    "Liberty", "Pleasant Hill", "Riverside", "Bethel", "Clinton",
    "Springfield", "Union", "Salem", "Greenfield", "Franklin", "Oakland",
    "Glendale", "Marion", "Shiloh", "Lebanon", "Antioch", "Hopewell",
    "Friendship", "Concord", "Harmony", "Pine Grove", "Greenwood",
    "Sulphur Springs", "Wildwood", "Lakeside", "Plainview", "Edgewood",
]
STREET_TYPES = ["Street", "Avenue", "Boulevard", "Circle", "Court", "Drive",
                "Lane", "Parkway", "Road", "Way"]
STREET_NAMES = ["Main", "Oak", "Park", "First", "Second", "Cedar", "Elm",
                "Maple", "Pine", "Washington", "Lake", "Hill", "Walnut",
                "Spring", "North", "Ridge", "River", "Sunset", "Railroad",
                "Church", "Willow", "Mill", "Forest", "Jackson", "Highland"]
COUNTRIES = [
    "United States", "Canada", "Mexico", "Germany", "France", "Japan",
    "United Kingdom", "Brazil", "India", "China", "Italy", "Spain",
    "Netherlands", "Australia", "Argentina", "Chile", "Peru", "Egypt",
    "Kenya", "Nigeria", "Norway", "Sweden", "Poland", "Portugal", "Greece",
    "Turkey", "Israel", "Jordan", "Thailand", "Vietnam",
]
# one shared low-cardinality zip pool across store/address/warehouse tables:
# zip-equality joins (q8/q19/q24) stay non-vacuous at tiny SF, and the zips
# the q8 template names literally all exist
ZIPS = [
    "24128", "57834", "13354", "15734", "78668", "76232", "62878", "82235",
    "78890", "60512", "26233", "51200", "63837", "40558", "81989", "88190",
    "35474", "10003", "10004", "10005", "10006", "10007", "10008", "10009",
] + [f"{z:05d}" for z in range(20000, 20176)]
MEALS = ["breakfast", "lunch", "dinner"]
SHIFTS = ["first", "second", "third"]
AM_PM = ["AM", "PM"]
SM_TYPES = ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "LIBRARY", "TWO DAY"]
SM_CODES = ["AIR", "SURFACE", "SEA"]
SM_CARRIERS = [
    "UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "TBS", "ZHOU", "ZOUROS",
    "MSC", "LATVIAN", "ALLIANCE", "ORIENTAL", "BARIAN", "BOXBUNDLES",
    "GREAT EASTERN", "DIAMOND", "RUPEKSA", "GERMA", "HARMSTORF", "PRIVATECARRIER",
]
REASONS = [
    "Package was damaged", "Stopped working", "Did not get it on time",
    "Not the product that was ordred", "Parts missing",
    "Does not work with a product that I have", "Gift exchange",
    "Did not like the color", "Did not like the model",
    "Did not like the make", "Did not like the warranty",
    "No service location in my area", "Found a better price in a store",
    "Found a better extended warranty in a store", "Not working any more",
    "unauthoized purchase", "duplicate purchase", "its is a fraudulent purchase",
    "it didn't fit my face", "reason 20", "reason 21", "reason 22",
    "reason 23", "reason 24", "reason 25", "reason 26", "reason 27",
    "reason 28", "reason 29", "reason 30", "reason 31", "reason 32",
    "reason 33", "reason 34", "reason 35",
]
FIRST_NAMES = [
    "James", "John", "Robert", "Michael", "William", "David", "Mary",
    "Patricia", "Linda", "Barbara", "Elizabeth", "Jennifer", "Maria",
    "Susan", "Margaret", "Dorothy", "Richard", "Charles", "Joseph",
    "Thomas", "Lisa", "Nancy", "Karen", "Betty", "Helen", "Daniel",
    "Matthew", "Anthony", "Mark", "Donald", "Paul", "Steven", "George",
    "Kenneth", "Sandra", "Donna", "Carol", "Ruth", "Sharon", "Michelle",
]
LAST_NAMES = [
    "Smith", "Johnson", "Williams", "Brown", "Jones", "Garcia", "Miller",
    "Davis", "Rodriguez", "Martinez", "Hernandez", "Lopez", "Gonzalez",
    "Wilson", "Anderson", "Thomas", "Taylor", "Moore", "Jackson", "Martin",
    "Lee", "Perez", "Thompson", "White", "Harris", "Sanchez", "Clark",
    "Ramirez", "Lewis", "Robinson", "Walker", "Young", "Allen", "King",
    "Wright", "Scott", "Torres", "Nguyen", "Hill", "Flores",
]

# SF-1 cardinalities (facts linear in SF; dims use dsdgen's sub-linear
# steps approximated as sqrt; date/time/demographics fixed)
_SF1 = {
    "store_sales": 2_880_000,
    "store_returns": 288_000,
    "catalog_sales": 1_440_000,
    "catalog_returns": 144_000,
    "web_sales": 720_000,
    "web_returns": 72_000,
    "inventory": 783_000,
    "customer": 100_000,
    "customer_address": 50_000,
    "item": 18_000,
    "promotion": 300,
    "store": 12,
    "warehouse": 5,
    "call_center": 6,
    "web_site": 30,
    "web_page": 60,
    "catalog_page": 11_718,
}

TABLES = [
    "date_dim", "time_dim", "item", "customer", "customer_address",
    "customer_demographics", "household_demographics", "income_band",
    "store", "warehouse", "call_center", "web_site", "web_page",
    "catalog_page", "promotion", "reason", "ship_mode",
    "store_sales", "store_returns", "catalog_sales", "catalog_returns",
    "web_sales", "web_returns", "inventory",
]


# ── HostBatch builders (what ``pa.array``/``pa.table`` did) ───────────────

_NP_TYPES = {
    np.dtype(np.int64): LONG,
    np.dtype(np.int32): INT,
    np.dtype(np.float64): DOUBLE,
    np.dtype(np.bool_): BOOLEAN,
}


def _strs(values) -> HostColumn:
    """A string column from Python strings (None for null)."""
    return string_column(list(values))


def _nullable(values, dt) -> HostColumn:
    """A fixed-width column from Python values or a numpy array, None for
    null (null slots zeroed)."""
    if isinstance(values, np.ndarray):
        return HostColumn(dt, values.astype(dt.np_dtype), np.ones(len(values), dtype=bool))
    vals = list(values)
    valid = np.array([v is not None for v in vals], dtype=bool)
    data = np.array([0 if v is None else v for v in vals], dtype=dt.np_dtype)
    return HostColumn(dt, data, valid)


def _table(cols: Dict[str, object]) -> HostBatch:
    """A HostBatch from named numpy arrays and HostColumns."""
    fields, out = [], []
    for name, c in cols.items():
        if not isinstance(c, HostColumn):
            arr = np.ascontiguousarray(c)
            c = HostColumn(_NP_TYPES[arr.dtype], arr, np.ones(len(arr), dtype=bool))
        fields.append(StructField(name, c.dtype))
        out.append(c)
    return HostBatch(Schema(fields), out, len(out[0]))


def _col(batch: HostBatch, name: str) -> HostColumn:
    return batch.columns[batch.schema.index_of(name)]


def _ints_or(batch: HostBatch, name: str, default: int) -> np.ndarray:
    """int64 values of a column with ``default`` where the value is null or
    0 (Python's ``v.as_py() or default``)."""
    c = _col(batch, name)
    return np.where(c.validity & (c.data != 0), c.data, default).astype(np.int64)


def _n(name: str, sf: float, linear: bool) -> int:
    base = _SF1[name]
    if linear:
        return max(10, int(base * sf))
    # dimensions scale ~ with sqrt(SF) like dsdgen's stepped scaling
    return max(10, int(base * (sf ** 0.5)))


def _money(rng, lo, hi, n):
    return np.round(rng.uniform(lo, hi, n), 2)


def _pick(rng, values: List[str], n: int) -> HostColumn:
    idx = rng.integers(0, len(values), n)
    return _strs([values[i] for i in idx])


def _id_col(prefix: str, n: int) -> HostColumn:
    return _strs([f"{prefix}{i:016d}" for i in range(1, n + 1)])


def _date32(days: np.ndarray) -> HostColumn:
    d = days.astype(np.int32)
    return HostColumn(DATE, d, np.ones(len(d), dtype=bool))


def _sk(days: np.ndarray) -> np.ndarray:
    return (days - DATE_LO + SK_BASE).astype(np.int64)


def _null_some(rng, arr: np.ndarray, frac: float) -> HostColumn:
    """Null out ~frac of an int64 fk column (dsdgen leaves fk gaps too)."""
    mask = rng.random(len(arr)) < frac
    data = np.where(mask, 0, np.asarray(arr, dtype=np.int64))
    return HostColumn(LONG, data, ~mask)


# ── dimensions ─────────────────────────────────────────────────────────────


def _gen_date_dim(sf, rng) -> HostBatch:
    days = np.arange(DATE_LO, DATE_HI + 1, dtype=np.int64)
    dates = [EPOCH + timedelta(days=int(d)) for d in days]
    years = np.array([d.year for d in dates], np.int64)
    moy = np.array([d.month for d in dates], np.int64)
    dom = np.array([d.day for d in dates], np.int64)
    dow = np.array([(d.weekday() + 1) % 7 for d in dates], np.int64)  # 0=Sunday
    qoy = (moy - 1) // 3 + 1
    week_seq = ((days - DATE_LO) // 7 + 5270).astype(np.int64)
    month_seq = ((years - 1970) * 12 + moy - 1).astype(np.int64)
    quarter_seq = ((years - 1970) * 4 + qoy - 1).astype(np.int64)
    day_names = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
                 "Friday", "Saturday"]
    first_dom = np.array([_days(d.year, d.month, 1) for d in dates], np.int64)
    return _table({
        "d_date_sk": _sk(days),
        "d_date_id": _id_col("AAAAAAAA", len(days)),
        "d_date": _date32(days),
        "d_month_seq": month_seq,
        "d_week_seq": week_seq,
        "d_quarter_seq": quarter_seq,
        "d_year": years,
        "d_dow": dow,
        "d_moy": moy,
        "d_dom": dom,
        "d_qoy": qoy,
        "d_fy_year": years,
        "d_fy_quarter_seq": quarter_seq,
        "d_fy_week_seq": week_seq,
        "d_day_name": _strs([day_names[i] for i in dow]),
        "d_quarter_name": _strs([f"{y}Q{q}" for y, q in zip(years, qoy)]),
        "d_holiday": _strs(["N"] * len(days)),
        "d_weekend": _strs(["Y" if i in (0, 6) else "N" for i in dow]),
        "d_following_holiday": _strs(["N"] * len(days)),
        "d_first_dom": _sk(first_dom),
        "d_last_dom": _sk(first_dom + 27),
        "d_same_day_ly": _sk(np.maximum(days - 365, DATE_LO)),
        "d_same_day_lq": _sk(np.maximum(days - 91, DATE_LO)),
        "d_current_day": _strs(["N"] * len(days)),
        "d_current_week": _strs(["N"] * len(days)),
        "d_current_month": _strs(["N"] * len(days)),
        "d_current_quarter": _strs(["N"] * len(days)),
        "d_current_year": _strs(["N"] * len(days)),
    })


def _gen_time_dim(sf, rng) -> HostBatch:
    # one row per minute of the day (queries bucket by hour/meal/shift)
    secs = np.arange(0, 86400, 60, dtype=np.int64)
    hours = secs // 3600
    minutes = (secs % 3600) // 60
    shift = np.where(hours < 8, 2, np.where(hours < 16, 0, 1))
    meal = np.where(
        (hours >= 6) & (hours < 9), 0,
        np.where((hours >= 11) & (hours < 14), 1,
                 np.where((hours >= 17) & (hours < 20), 2, -1)),
    )
    return _table({
        "t_time_sk": secs,
        "t_time_id": _id_col("AAAAAAAA", len(secs)),
        "t_time": secs,
        "t_hour": hours,
        "t_minute": minutes,
        "t_second": np.zeros(len(secs), np.int64),
        "t_am_pm": _strs([AM_PM[0] if h < 12 else AM_PM[1] for h in hours]),
        "t_shift": _strs([SHIFTS[i] for i in shift]),
        "t_sub_shift": _strs([SHIFTS[i] for i in shift]),
        "t_meal_time": _strs(
            [MEALS[i] if i >= 0 else None for i in meal]
        ),
    })


def _gen_item(sf, rng) -> HostBatch:
    n = _n("item", sf, linear=False)
    cat_idx = rng.integers(0, len(CATEGORIES), n)
    class_idx = rng.integers(0, CLASSES_PER_CAT, n)
    brand_id = (cat_idx + 1) * 1_000_000 + class_idx * 1000 + rng.integers(1, 10, n)
    manu_id = rng.integers(1, 1001, n)
    price = _money(rng, 0.5, 300.0, n)
    rec_start = np.full(n, _days(1997, 1, 1), np.int64)
    return _table({
        "i_item_sk": np.arange(1, n + 1, dtype=np.int64),
        "i_item_id": _id_col("AAAAAAAA", n),
        "i_rec_start_date": _date32(rec_start),
        "i_rec_end_date": _nullable([None] * n, DATE),
        "i_item_desc": _pick(rng, [
            "carefully packed product", "bright popular gadget",
            "durable household staple", "imported seasonal special",
            "classic bestselling title", "quiet reliable tool",
            "colorful youth favorite", "premium branded accessory",
        ], n),
        "i_current_price": price,
        "i_wholesale_cost": np.round(price * rng.uniform(0.4, 0.8, n), 2),
        "i_brand_id": brand_id.astype(np.int64),
        "i_brand": _strs([f"brandbrand#{b % 100000}" for b in brand_id]),
        "i_class_id": class_idx.astype(np.int64) + 1,
        "i_class": _strs(
            [f"{CATEGORIES[c].lower()}class{k + 1}"
             for c, k in zip(cat_idx, class_idx)]
        ),
        "i_category_id": cat_idx.astype(np.int64) + 1,
        "i_category": _strs([CATEGORIES[c] for c in cat_idx]),
        "i_manufact_id": manu_id.astype(np.int64),
        "i_manufact": _strs([f"manufact#{m}" for m in manu_id]),
        "i_size": _pick(rng, SIZES, n),
        "i_formulation": _pick(rng, COLORS, n),
        "i_color": _pick(rng, COLORS, n),
        "i_units": _pick(rng, UNITS, n),
        "i_container": _strs(["Unknown"] * n),
        "i_manager_id": rng.integers(1, 101, n).astype(np.int64),
        "i_product_name": _strs([f"product{i}" for i in range(1, n + 1)]),
    })


def _gen_customer(sf, rng, n_cd, n_hd, n_addr) -> HostBatch:
    n = _n("customer", sf, linear=False)
    first_sales = rng.integers(DATE_LO, DATE_HI - 365, n)
    return _table({
        "c_customer_sk": np.arange(1, n + 1, dtype=np.int64),
        "c_customer_id": _id_col("AAAAAAAA", n),
        "c_current_cdemo_sk": _null_some(
            rng, rng.integers(1, n_cd + 1, n), 0.02
        ),
        "c_current_hdemo_sk": _null_some(
            rng, rng.integers(1, n_hd + 1, n), 0.02
        ),
        "c_current_addr_sk": rng.integers(1, n_addr + 1, n).astype(np.int64),
        "c_first_shipto_date_sk": _sk(first_sales + 30).astype(np.int64),
        "c_first_sales_date_sk": _sk(first_sales).astype(np.int64),
        "c_salutation": _pick(rng, ["Mr.", "Mrs.", "Ms.", "Dr.", "Miss", "Sir"], n),
        "c_first_name": _pick(rng, FIRST_NAMES, n),
        "c_last_name": _pick(rng, LAST_NAMES, n),
        "c_preferred_cust_flag": _pick(rng, ["Y", "N"], n),
        "c_birth_day": rng.integers(1, 29, n).astype(np.int64),
        "c_birth_month": rng.integers(1, 13, n).astype(np.int64),
        "c_birth_year": rng.integers(1930, 1993, n).astype(np.int64),
        "c_birth_country": _pick(rng, [c.upper() for c in COUNTRIES], n),
        "c_login": _strs([None] * n),
        "c_email_address": _strs(
            [f"user{i}@example.com" for i in range(1, n + 1)]
        ),
        "c_last_review_date_sk": _sk(
            rng.integers(DATE_LO, DATE_HI, n)
        ).astype(np.int64),
    })


def _gen_customer_address(sf, rng) -> HostBatch:
    n = _n("customer_address", sf, linear=False)
    return _table({
        "ca_address_sk": np.arange(1, n + 1, dtype=np.int64),
        "ca_address_id": _id_col("AAAAAAAA", n),
        "ca_street_number": _strs(
            [str(x) for x in rng.integers(1, 1000, n)]
        ),
        "ca_street_name": _pick(rng, STREET_NAMES, n),
        "ca_street_type": _pick(rng, STREET_TYPES, n),
        "ca_suite_number": _strs(
            [f"Suite {x}" for x in rng.integers(0, 500, n)]
        ),
        "ca_city": _pick(rng, CITIES, n),
        "ca_county": _pick(rng, COUNTIES, n),
        "ca_state": _pick(rng, STATES, n),
        "ca_zip": _pick(rng, ZIPS, n),
        "ca_country": _strs(["United States"] * n),
        "ca_gmt_offset": rng.choice([-5.0, -6.0, -7.0, -8.0], n),
        "ca_location_type": _pick(
            rng, ["apartment", "condo", "single family"], n
        ),
    })


def _gen_customer_demographics(sf, rng) -> HostBatch:
    # full cross product of the three filtered dims x sampled tail dims —
    # every (gender, marital, education) combo a query names exists
    rows = []
    sk = 1
    for g in GENDERS:
        for m in MARITAL:
            for e in EDUCATION:
                for pe in range(500, 10001, 500):
                    rows.append((sk, g, m, e, pe))
                    sk += 1
    n = len(rows)
    arr = lambda i: [r[i] for r in rows]  # noqa: E731
    return _table({
        "cd_demo_sk": _nullable(arr(0), LONG),
        "cd_gender": _strs(arr(1)),
        "cd_marital_status": _strs(arr(2)),
        "cd_education_status": _strs(arr(3)),
        "cd_purchase_estimate": _nullable(arr(4), LONG),
        "cd_credit_rating": _strs(
            [CREDIT[i % len(CREDIT)] for i in range(n)]
        ),
        "cd_dep_count": _nullable([i % 7 for i in range(n)], LONG),
        "cd_dep_employed_count": _nullable(
            [(i // 7) % 7 for i in range(n)], LONG),
        "cd_dep_college_count": _nullable(
            [(i // 49) % 7 for i in range(n)], LONG),
    })


def _gen_household_demographics(sf, rng) -> HostBatch:
    rows = []
    sk = 1
    for ib in range(1, 21):
        for bp in BUY_POTENTIAL:
            for dep in range(0, 10):
                for veh in range(-1, 5):
                    rows.append((sk, ib, bp, dep, veh))
                    sk += 1
    return _table({
        "hd_demo_sk": _nullable([r[0] for r in rows], LONG),
        "hd_income_band_sk": _nullable([r[1] for r in rows], LONG),
        "hd_buy_potential": _strs([r[2] for r in rows]),
        "hd_dep_count": _nullable([r[3] for r in rows], LONG),
        "hd_vehicle_count": _nullable([r[4] for r in rows], LONG),
    })


def _gen_income_band(sf, rng) -> HostBatch:
    lo = np.arange(0, 200000, 10000, dtype=np.int64)
    return _table({
        "ib_income_band_sk": np.arange(1, 21, dtype=np.int64),
        "ib_lower_bound": lo,
        "ib_upper_bound": lo + 10000,
    })


def _gen_store(sf, rng) -> HostBatch:
    n = max(2, _n("store", sf, linear=False))
    return _table({
        "s_store_sk": np.arange(1, n + 1, dtype=np.int64),
        "s_store_id": _id_col("AAAAAAAA", n),
        "s_rec_start_date": _date32(np.full(n, _days(1997, 1, 1), np.int64)),
        "s_rec_end_date": _nullable([None] * n, DATE),
        "s_closed_date_sk": _nullable([None] * n, LONG),
        "s_store_name": _pick(rng, ["ought", "able", "pri", "ese", "anti",
                                    "cally", "ation", "eing", "bar"], n),
        "s_number_employees": rng.integers(200, 301, n).astype(np.int64),
        "s_floor_space": rng.integers(5_000_000, 10_000_001, n).astype(np.int64),
        "s_hours": _pick(rng, ["8AM-4PM", "8AM-12AM", "8AM-8AM"], n),
        "s_manager": _pick(rng, [f"{f} {l}" for f, l in
                                 zip(FIRST_NAMES[:20], LAST_NAMES[:20])], n),
        "s_market_id": rng.integers(1, 11, n).astype(np.int64),
        "s_geography_class": _strs(["Unknown"] * n),
        "s_market_desc": _strs(["store market description"] * n),
        "s_market_manager": _pick(rng, [f"{f} {l}" for f, l in
                                        zip(FIRST_NAMES[20:], LAST_NAMES[20:])], n),
        "s_division_id": np.ones(n, np.int64),
        "s_division_name": _strs(["Unknown"] * n),
        "s_company_id": np.ones(n, np.int64),
        "s_company_name": _strs(["Unknown"] * n),
        "s_street_number": _strs([str(x) for x in rng.integers(1, 1000, n)]),
        "s_street_name": _pick(rng, STREET_NAMES, n),
        "s_street_type": _pick(rng, STREET_TYPES, n),
        "s_suite_number": _strs([f"Suite {x}" for x in rng.integers(0, 500, n)]),
        "s_city": _pick(rng, CITIES[:8], n),
        "s_county": _pick(rng, COUNTIES[:6], n),
        "s_state": _pick(rng, STATES[:8], n),
        "s_zip": _pick(rng, ZIPS, n),
        "s_country": _strs(["United States"] * n),
        "s_gmt_offset": rng.choice([-5.0, -6.0], n),
        "s_tax_precentage": np.round(rng.uniform(0.0, 0.11, n), 2),
    })


def _gen_warehouse(sf, rng) -> HostBatch:
    n = max(2, _n("warehouse", sf, linear=False))
    return _table({
        "w_warehouse_sk": np.arange(1, n + 1, dtype=np.int64),
        "w_warehouse_id": _id_col("AAAAAAAA", n),
        "w_warehouse_name": _pick(rng, [
            "Conventional childr", "Important issues liv", "Doors canno",
            "Bad cards must make.", "Rooms cook ",
        ], n),
        "w_warehouse_sq_ft": rng.integers(50_000, 1_000_001, n).astype(np.int64),
        "w_street_number": _strs([str(x) for x in rng.integers(1, 1000, n)]),
        "w_street_name": _pick(rng, STREET_NAMES, n),
        "w_street_type": _pick(rng, STREET_TYPES, n),
        "w_suite_number": _strs([f"Suite {x}" for x in rng.integers(0, 500, n)]),
        "w_city": _pick(rng, CITIES[:8], n),
        "w_county": _pick(rng, COUNTIES[:6], n),
        "w_state": _pick(rng, STATES[:8], n),
        "w_zip": _pick(rng, ZIPS, n),
        "w_country": _strs(["United States"] * n),
        "w_gmt_offset": rng.choice([-5.0, -6.0], n),
    })


def _gen_call_center(sf, rng) -> HostBatch:
    n = max(2, _n("call_center", sf, linear=False))
    return _table({
        "cc_call_center_sk": np.arange(1, n + 1, dtype=np.int64),
        "cc_call_center_id": _id_col("AAAAAAAA", n),
        "cc_rec_start_date": _date32(np.full(n, _days(1997, 1, 1), np.int64)),
        "cc_rec_end_date": _nullable([None] * n, DATE),
        "cc_closed_date_sk": _nullable([None] * n, LONG),
        "cc_open_date_sk": _sk(np.full(n, DATE_LO, np.int64)).astype(np.int64),
        "cc_name": _strs([f"call center {i}" for i in range(1, n + 1)]),
        "cc_class": _pick(rng, ["small", "medium", "large"], n),
        "cc_employees": rng.integers(1, 7, n).astype(np.int64),
        "cc_sq_ft": rng.integers(1000, 4000, n).astype(np.int64),
        "cc_hours": _pick(rng, ["8AM-4PM", "8AM-12AM", "8AM-8AM"], n),
        "cc_manager": _pick(rng, [f"{f} {l}" for f, l in
                                  zip(FIRST_NAMES[:20], LAST_NAMES[:20])], n),
        "cc_mkt_id": rng.integers(1, 7, n).astype(np.int64),
        "cc_mkt_class": _strs(["Unknown"] * n),
        "cc_mkt_desc": _strs(["call center market desc"] * n),
        "cc_market_manager": _pick(rng, [f"{f} {l}" for f, l in
                                         zip(FIRST_NAMES[20:], LAST_NAMES[20:])], n),
        "cc_division": np.ones(n, np.int64),
        "cc_division_name": _strs(["Unknown"] * n),
        "cc_company": np.ones(n, np.int64),
        "cc_company_name": _strs(["Unknown"] * n),
        "cc_street_number": _strs([str(x) for x in rng.integers(1, 1000, n)]),
        "cc_street_name": _pick(rng, STREET_NAMES, n),
        "cc_street_type": _pick(rng, STREET_TYPES, n),
        "cc_suite_number": _strs([f"Suite {x}" for x in rng.integers(0, 500, n)]),
        "cc_city": _pick(rng, CITIES[:8], n),
        "cc_county": _pick(rng, COUNTIES[:6], n),
        "cc_state": _pick(rng, STATES[:8], n),
        "cc_zip": _pick(rng, ZIPS, n),
        "cc_country": _strs(["United States"] * n),
        "cc_gmt_offset": rng.choice([-5.0, -6.0], n),
        "cc_tax_percentage": np.round(rng.uniform(0.0, 0.12, n), 2),
    })


def _gen_web_site(sf, rng) -> HostBatch:
    n = max(2, _n("web_site", sf, linear=False))
    return _table({
        "web_site_sk": np.arange(1, n + 1, dtype=np.int64),
        "web_site_id": _id_col("AAAAAAAA", n),
        "web_rec_start_date": _date32(np.full(n, _days(1997, 1, 1), np.int64)),
        "web_rec_end_date": _nullable([None] * n, DATE),
        "web_name": _strs([f"site_{i}" for i in range(n)]),
        "web_open_date_sk": _sk(np.full(n, DATE_LO, np.int64)).astype(np.int64),
        "web_close_date_sk": _nullable([None] * n, LONG),
        "web_class": _strs(["Unknown"] * n),
        "web_manager": _pick(rng, [f"{f} {l}" for f, l in
                                   zip(FIRST_NAMES[:20], LAST_NAMES[:20])], n),
        "web_mkt_id": rng.integers(1, 7, n).astype(np.int64),
        "web_mkt_class": _strs(["Unknown"] * n),
        "web_mkt_desc": _strs(["web market desc"] * n),
        "web_market_manager": _pick(rng, [f"{f} {l}" for f, l in
                                          zip(FIRST_NAMES[20:], LAST_NAMES[20:])], n),
        "web_company_id": np.ones(n, np.int64),
        "web_company_name": _pick(rng, ["pri", "able", "ought", "bar", "ese"], n),
        "web_street_number": _strs([str(x) for x in rng.integers(1, 1000, n)]),
        "web_street_name": _pick(rng, STREET_NAMES, n),
        "web_street_type": _pick(rng, STREET_TYPES, n),
        "web_suite_number": _strs([f"Suite {x}" for x in rng.integers(0, 500, n)]),
        "web_city": _pick(rng, CITIES[:8], n),
        "web_county": _pick(rng, COUNTIES[:6], n),
        "web_state": _pick(rng, STATES[:8], n),
        "web_zip": _pick(rng, ZIPS, n),
        "web_country": _strs(["United States"] * n),
        "web_gmt_offset": rng.choice([-5.0, -6.0], n),
        "web_tax_percentage": np.round(rng.uniform(0.0, 0.12, n), 2),
    })


def _gen_web_page(sf, rng) -> HostBatch:
    n = max(2, _n("web_page", sf, linear=False))
    return _table({
        "wp_web_page_sk": np.arange(1, n + 1, dtype=np.int64),
        "wp_web_page_id": _id_col("AAAAAAAA", n),
        "wp_rec_start_date": _date32(np.full(n, _days(1997, 1, 1), np.int64)),
        "wp_rec_end_date": _nullable([None] * n, DATE),
        "wp_creation_date_sk": _sk(np.full(n, DATE_LO, np.int64)).astype(np.int64),
        "wp_access_date_sk": _sk(np.full(n, DATE_LO + 100, np.int64)).astype(np.int64),
        "wp_autogen_flag": _pick(rng, ["Y", "N"], n),
        "wp_customer_sk": _nullable([None] * n, LONG),
        "wp_url": _strs(["http://www.foo.com"] * n),
        "wp_type": _pick(rng, ["ad", "bio", "feedback", "general",
                               "order", "protected", "welcome"], n),
        "wp_char_count": rng.integers(100, 8000, n).astype(np.int64),
        "wp_link_count": rng.integers(2, 25, n).astype(np.int64),
        "wp_image_count": rng.integers(1, 7, n).astype(np.int64),
        "wp_max_ad_count": rng.integers(0, 4, n).astype(np.int64),
    })


def _gen_catalog_page(sf, rng) -> HostBatch:
    n = _n("catalog_page", sf, linear=False)
    return _table({
        "cp_catalog_page_sk": np.arange(1, n + 1, dtype=np.int64),
        "cp_catalog_page_id": _id_col("AAAAAAAA", n),
        "cp_start_date_sk": _sk(np.full(n, DATE_LO, np.int64)).astype(np.int64),
        "cp_end_date_sk": _sk(np.full(n, DATE_HI, np.int64)).astype(np.int64),
        "cp_department": _strs(["DEPARTMENT"] * n),
        "cp_catalog_number": rng.integers(1, 110, n).astype(np.int64),
        "cp_catalog_page_number": rng.integers(1, 110, n).astype(np.int64),
        "cp_description": _pick(rng, [
            "catalog page one", "catalog page two", "catalog page three",
        ], n),
        "cp_type": _pick(rng, ["bi-annual", "quarterly", "monthly"], n),
    })


def _gen_promotion(sf, rng, n_items) -> HostBatch:
    n = _n("promotion", sf, linear=False)
    start = rng.integers(DATE_LO, DATE_HI - 60, n)
    yn = lambda: _pick(rng, ["N", "N", "N", "Y"], n)  # noqa: E731
    return _table({
        "p_promo_sk": np.arange(1, n + 1, dtype=np.int64),
        "p_promo_id": _id_col("AAAAAAAA", n),
        "p_start_date_sk": _sk(start).astype(np.int64),
        "p_end_date_sk": _sk(start + rng.integers(10, 60, n)).astype(np.int64),
        "p_item_sk": rng.integers(1, n_items + 1, n).astype(np.int64),
        "p_cost": np.round(rng.uniform(500.0, 2000.0, n), 2),
        "p_response_target": np.ones(n, np.int64),
        "p_promo_name": _pick(rng, ["anti", "ought", "able", "pri",
                                    "ese", "cally", "ation"], n),
        "p_channel_dmail": yn(),
        "p_channel_email": yn(),
        "p_channel_catalog": yn(),
        "p_channel_tv": yn(),
        "p_channel_radio": yn(),
        "p_channel_press": yn(),
        "p_channel_event": yn(),
        "p_channel_demo": yn(),
        "p_channel_details": _strs(["promo details"] * n),
        "p_purpose": _pick(rng, ["Unknown"], n),
        "p_discount_active": _strs(["N"] * n),
    })


def _gen_reason(sf, rng) -> HostBatch:
    n = len(REASONS)
    return _table({
        "r_reason_sk": np.arange(1, n + 1, dtype=np.int64),
        "r_reason_id": _id_col("AAAAAAAA", n),
        "r_reason_desc": _strs(REASONS),
    })


def _gen_ship_mode(sf, rng) -> HostBatch:
    n = 20
    return _table({
        "sm_ship_mode_sk": np.arange(1, n + 1, dtype=np.int64),
        "sm_ship_mode_id": _id_col("AAAAAAAA", n),
        "sm_type": _strs([SM_TYPES[i % len(SM_TYPES)] for i in range(n)]),
        "sm_code": _strs([SM_CODES[i % len(SM_CODES)] for i in range(n)]),
        "sm_carrier": _strs(SM_CARRIERS[:n]),
        "sm_contract": _strs([f"contract{i}" for i in range(n)]),
    })


# ── facts ──────────────────────────────────────────────────────────────────


def _sales_money(rng, n, qty):
    """The spec's per-line money chain (wholesale→list→sales→ext columns)."""
    wholesale = _money(rng, 1.0, 100.0, n)
    list_price = np.round(wholesale * rng.uniform(1.0, 2.0, n), 2)
    sales_price = np.round(list_price * rng.uniform(0.0, 1.0, n), 2)
    ext_discount = np.round((list_price - sales_price) * qty, 2)
    ext_sales = np.round(sales_price * qty, 2)
    ext_wholesale = np.round(wholesale * qty, 2)
    ext_list = np.round(list_price * qty, 2)
    tax = np.round(ext_sales * rng.uniform(0.0, 0.09, n), 2)
    coupon = np.where(rng.random(n) < 0.1,
                      np.round(ext_sales * rng.uniform(0.0, 0.5, n), 2), 0.0)
    net_paid = np.round(ext_sales - coupon, 2)
    net_paid_tax = np.round(net_paid + tax, 2)
    net_profit = np.round(net_paid - ext_wholesale, 2)
    return dict(
        wholesale=wholesale, list=list_price, sales=sales_price,
        ext_discount=ext_discount, ext_sales=ext_sales,
        ext_wholesale=ext_wholesale, ext_list=ext_list, tax=tax,
        coupon=coupon, net_paid=net_paid, net_paid_tax=net_paid_tax,
        net_profit=net_profit,
    )


def _fact_dims(sf):
    return {
        "item": _n("item", sf, linear=False),
        "customer": _n("customer", sf, linear=False),
        "addr": _n("customer_address", sf, linear=False),
        "cd": 2 * 5 * 7 * 20,
        "hd": 20 * 6 * 10 * 6,
        "store": max(2, _n("store", sf, linear=False)),
        "warehouse": max(2, _n("warehouse", sf, linear=False)),
        "promo": _n("promotion", sf, linear=False),
        "web_site": max(2, _n("web_site", sf, linear=False)),
        "web_page": max(2, _n("web_page", sf, linear=False)),
        "call_center": max(2, _n("call_center", sf, linear=False)),
        "catalog_page": _n("catalog_page", sf, linear=False),
        "time": 1440,
    }


def _gen_store_sales(sf, rng) -> HostBatch:
    n = _n("store_sales", sf, linear=True)
    d = _fact_dims(sf)
    sold = rng.integers(_days(1998, 1, 1), _days(2002, 12, 31), n)
    qty = rng.integers(1, 101, n)
    m = _sales_money(rng, n, qty)
    return _table({
        "ss_sold_date_sk": _null_some(rng, _sk(sold), 0.02),
        "ss_sold_time_sk": (rng.integers(0, d["time"], n) * 60).astype(np.int64),
        "ss_item_sk": rng.integers(1, d["item"] + 1, n).astype(np.int64),
        "ss_customer_sk": _null_some(
            rng, rng.integers(1, d["customer"] + 1, n), 0.02
        ),
        "ss_cdemo_sk": _null_some(rng, rng.integers(1, d["cd"] + 1, n), 0.02),
        "ss_hdemo_sk": _null_some(rng, rng.integers(1, d["hd"] + 1, n), 0.02),
        "ss_addr_sk": _null_some(rng, rng.integers(1, d["addr"] + 1, n), 0.02),
        "ss_store_sk": _null_some(rng, rng.integers(1, d["store"] + 1, n), 0.02),
        "ss_promo_sk": _null_some(rng, rng.integers(1, d["promo"] + 1, n), 0.1),
        "ss_ticket_number": (np.arange(n, dtype=np.int64) // 4 + 1),
        "ss_quantity": qty.astype(np.int64),
        "ss_wholesale_cost": m["wholesale"],
        "ss_list_price": m["list"],
        "ss_sales_price": m["sales"],
        "ss_ext_discount_amt": m["ext_discount"],
        "ss_ext_sales_price": m["ext_sales"],
        "ss_ext_wholesale_cost": m["ext_wholesale"],
        "ss_ext_list_price": m["ext_list"],
        "ss_ext_tax": m["tax"],
        "ss_coupon_amt": m["coupon"],
        "ss_net_paid": m["net_paid"],
        "ss_net_paid_inc_tax": m["net_paid_tax"],
        "ss_net_profit": m["net_profit"],
    })


def _returns_from(sales: HostBatch, rng, frac: float, cols: Dict[str, str],
                  extra: Callable) -> HostBatch:
    """Sample ~frac of a sales fact into its returns fact, carrying the join
    identity columns (ticket/order number + item + customer) so the
    multi-channel sales⋈returns chains are non-vacuous."""
    n_src = sales.num_rows
    idx = np.flatnonzero(rng.random(n_src) < frac)
    sample = sales.take(idx)
    return extra(sample, idx)


def _gen_store_returns(sf, rng, store_sales: HostBatch) -> HostBatch:
    def build(sample: HostBatch, idx) -> HostBatch:
        n = sample.num_rows
        sold = _ints_or(sample, "ss_sold_date_sk", SK_BASE)
        ret_day = sold + rng.integers(1, 90, n)
        qty_sold = _col(sample, "ss_quantity").data.astype(np.int64)
        ret_qty = np.maximum(1, (qty_sold * rng.uniform(0.1, 1.0, n)).astype(np.int64))
        sales_price = _col(sample, "ss_sales_price").data.astype(np.float64)
        amt = np.round(sales_price * ret_qty, 2)
        tax = np.round(amt * 0.05, 2)
        fee = _money(rng, 0.5, 100.0, n)
        ship = _money(rng, 0.0, 50.0, n)
        refunded = np.round(amt * rng.uniform(0.3, 1.0, n), 2)
        reversed_ = np.round((amt - refunded) * 0.5, 2)
        credit = np.round(amt - refunded - reversed_, 2)
        return _table({
            "sr_returned_date_sk": _nullable(
                np.minimum(ret_day, SK_BASE + N_DATES - 1), LONG),
            "sr_return_time_sk": (rng.integers(0, 1440, n) * 60).astype(np.int64),
            "sr_item_sk": _col(sample, "ss_item_sk"),
            "sr_customer_sk": _col(sample, "ss_customer_sk"),
            "sr_cdemo_sk": _col(sample, "ss_cdemo_sk"),
            "sr_hdemo_sk": _col(sample, "ss_hdemo_sk"),
            "sr_addr_sk": _col(sample, "ss_addr_sk"),
            "sr_store_sk": _col(sample, "ss_store_sk"),
            "sr_reason_sk": rng.integers(1, len(REASONS) + 1, n).astype(np.int64),
            "sr_ticket_number": _col(sample, "ss_ticket_number"),
            "sr_return_quantity": ret_qty,
            "sr_return_amt": amt,
            "sr_return_tax": tax,
            "sr_return_amt_inc_tax": np.round(amt + tax, 2),
            "sr_fee": fee,
            "sr_return_ship_cost": ship,
            "sr_refunded_cash": refunded,
            "sr_reversed_charge": reversed_,
            "sr_store_credit": credit,
            "sr_net_loss": np.round(amt * 0.1 + fee + ship, 2),
        })

    return _returns_from(store_sales, rng, 0.1, {}, build)


def _gen_catalog_sales(sf, rng) -> HostBatch:
    n = _n("catalog_sales", sf, linear=True)
    d = _fact_dims(sf)
    sold = rng.integers(_days(1998, 1, 1), _days(2002, 12, 31), n)
    ship = sold + rng.integers(1, 140, n)
    qty = rng.integers(1, 101, n)
    m = _sales_money(rng, n, qty)
    ship_cost = np.round(m["ext_sales"] * rng.uniform(0.0, 0.2, n), 2)
    bill_cust = rng.integers(1, d["customer"] + 1, n)
    # ~15% drop-ship to a different customer (q? bill<>ship filters)
    ship_cust = np.where(
        rng.random(n) < 0.15,
        rng.integers(1, d["customer"] + 1, n), bill_cust,
    )
    return _table({
        "cs_sold_date_sk": _null_some(rng, _sk(sold), 0.02),
        "cs_sold_time_sk": (rng.integers(0, d["time"], n) * 60).astype(np.int64),
        "cs_ship_date_sk": _sk(np.minimum(ship, DATE_HI)).astype(np.int64),
        "cs_bill_customer_sk": bill_cust.astype(np.int64),
        "cs_bill_cdemo_sk": rng.integers(1, d["cd"] + 1, n).astype(np.int64),
        "cs_bill_hdemo_sk": rng.integers(1, d["hd"] + 1, n).astype(np.int64),
        "cs_bill_addr_sk": rng.integers(1, d["addr"] + 1, n).astype(np.int64),
        "cs_ship_customer_sk": ship_cust.astype(np.int64),
        "cs_ship_cdemo_sk": rng.integers(1, d["cd"] + 1, n).astype(np.int64),
        "cs_ship_hdemo_sk": rng.integers(1, d["hd"] + 1, n).astype(np.int64),
        "cs_ship_addr_sk": rng.integers(1, d["addr"] + 1, n).astype(np.int64),
        "cs_call_center_sk": _null_some(
            rng, rng.integers(1, d["call_center"] + 1, n), 0.02
        ),
        "cs_catalog_page_sk": rng.integers(
            1, d["catalog_page"] + 1, n
        ).astype(np.int64),
        "cs_ship_mode_sk": rng.integers(1, 21, n).astype(np.int64),
        "cs_warehouse_sk": rng.integers(1, d["warehouse"] + 1, n).astype(np.int64),
        "cs_item_sk": rng.integers(1, d["item"] + 1, n).astype(np.int64),
        "cs_promo_sk": _null_some(rng, rng.integers(1, d["promo"] + 1, n), 0.1),
        "cs_order_number": (np.arange(n, dtype=np.int64) // 3 + 1),
        "cs_quantity": qty.astype(np.int64),
        "cs_wholesale_cost": m["wholesale"],
        "cs_list_price": m["list"],
        "cs_sales_price": m["sales"],
        "cs_ext_discount_amt": m["ext_discount"],
        "cs_ext_sales_price": m["ext_sales"],
        "cs_ext_wholesale_cost": m["ext_wholesale"],
        "cs_ext_list_price": m["ext_list"],
        "cs_ext_tax": m["tax"],
        "cs_coupon_amt": m["coupon"],
        "cs_ext_ship_cost": ship_cost,
        "cs_net_paid": m["net_paid"],
        "cs_net_paid_inc_tax": m["net_paid_tax"],
        "cs_net_paid_inc_ship": np.round(m["net_paid"] + ship_cost, 2),
        "cs_net_paid_inc_ship_tax": np.round(
            m["net_paid_tax"] + ship_cost, 2
        ),
        "cs_net_profit": m["net_profit"],
    })


def _gen_catalog_returns(sf, rng, catalog_sales: HostBatch) -> HostBatch:
    def build(sample: HostBatch, idx) -> HostBatch:
        n = sample.num_rows
        sold = _ints_or(sample, "cs_sold_date_sk", SK_BASE)
        ret_day = np.minimum(sold + rng.integers(1, 90, n), SK_BASE + N_DATES - 1)
        qty_sold = _col(sample, "cs_quantity").data.astype(np.int64)
        ret_qty = np.maximum(1, (qty_sold * rng.uniform(0.1, 1.0, n)).astype(np.int64))
        sales_price = _col(sample, "cs_sales_price").data.astype(np.float64)
        amt = np.round(sales_price * ret_qty, 2)
        tax = np.round(amt * 0.05, 2)
        fee = _money(rng, 0.5, 100.0, n)
        ship = _money(rng, 0.0, 50.0, n)
        refunded = np.round(amt * rng.uniform(0.3, 1.0, n), 2)
        reversed_ = np.round((amt - refunded) * 0.5, 2)
        return _table({
            "cr_returned_date_sk": _nullable(ret_day, LONG),
            "cr_returned_time_sk": (rng.integers(0, 1440, n) * 60).astype(np.int64),
            "cr_item_sk": _col(sample, "cs_item_sk"),
            "cr_refunded_customer_sk": _col(sample, "cs_bill_customer_sk"),
            "cr_refunded_cdemo_sk": _col(sample, "cs_bill_cdemo_sk"),
            "cr_refunded_hdemo_sk": _col(sample, "cs_bill_hdemo_sk"),
            "cr_refunded_addr_sk": _col(sample, "cs_bill_addr_sk"),
            "cr_returning_customer_sk": _col(sample, "cs_ship_customer_sk"),
            "cr_returning_cdemo_sk": _col(sample, "cs_ship_cdemo_sk"),
            "cr_returning_hdemo_sk": _col(sample, "cs_ship_hdemo_sk"),
            "cr_returning_addr_sk": _col(sample, "cs_ship_addr_sk"),
            "cr_call_center_sk": _col(sample, "cs_call_center_sk"),
            "cr_catalog_page_sk": _col(sample, "cs_catalog_page_sk"),
            "cr_ship_mode_sk": _col(sample, "cs_ship_mode_sk"),
            "cr_warehouse_sk": _col(sample, "cs_warehouse_sk"),
            "cr_reason_sk": rng.integers(1, len(REASONS) + 1, n).astype(np.int64),
            "cr_order_number": _col(sample, "cs_order_number"),
            "cr_return_quantity": ret_qty,
            "cr_return_amount": amt,
            "cr_return_tax": tax,
            "cr_return_amt_inc_tax": np.round(amt + tax, 2),
            "cr_fee": fee,
            "cr_return_ship_cost": ship,
            "cr_refunded_cash": refunded,
            "cr_reversed_charge": reversed_,
            "cr_store_credit": np.round(amt - refunded - reversed_, 2),
            "cr_net_loss": np.round(amt * 0.1 + fee + ship, 2),
        })

    return _returns_from(catalog_sales, rng, 0.1, {}, build)


def _gen_web_sales(sf, rng) -> HostBatch:
    n = _n("web_sales", sf, linear=True)
    d = _fact_dims(sf)
    sold = rng.integers(_days(1998, 1, 1), _days(2002, 12, 31), n)
    ship = sold + rng.integers(1, 140, n)
    qty = rng.integers(1, 101, n)
    m = _sales_money(rng, n, qty)
    ship_cost = np.round(m["ext_sales"] * rng.uniform(0.0, 0.2, n), 2)
    bill_cust = rng.integers(1, d["customer"] + 1, n)
    ship_cust = np.where(
        rng.random(n) < 0.15,
        rng.integers(1, d["customer"] + 1, n), bill_cust,
    )
    return _table({
        "ws_sold_date_sk": _null_some(rng, _sk(sold), 0.02),
        "ws_sold_time_sk": (rng.integers(0, d["time"], n) * 60).astype(np.int64),
        "ws_ship_date_sk": _sk(np.minimum(ship, DATE_HI)).astype(np.int64),
        "ws_item_sk": rng.integers(1, d["item"] + 1, n).astype(np.int64),
        "ws_bill_customer_sk": bill_cust.astype(np.int64),
        "ws_bill_cdemo_sk": rng.integers(1, d["cd"] + 1, n).astype(np.int64),
        "ws_bill_hdemo_sk": rng.integers(1, d["hd"] + 1, n).astype(np.int64),
        "ws_bill_addr_sk": rng.integers(1, d["addr"] + 1, n).astype(np.int64),
        "ws_ship_customer_sk": ship_cust.astype(np.int64),
        "ws_ship_cdemo_sk": rng.integers(1, d["cd"] + 1, n).astype(np.int64),
        "ws_ship_hdemo_sk": rng.integers(1, d["hd"] + 1, n).astype(np.int64),
        "ws_ship_addr_sk": rng.integers(1, d["addr"] + 1, n).astype(np.int64),
        "ws_web_page_sk": rng.integers(1, d["web_page"] + 1, n).astype(np.int64),
        "ws_web_site_sk": rng.integers(1, d["web_site"] + 1, n).astype(np.int64),
        "ws_ship_mode_sk": rng.integers(1, 21, n).astype(np.int64),
        "ws_warehouse_sk": rng.integers(1, d["warehouse"] + 1, n).astype(np.int64),
        "ws_promo_sk": _null_some(rng, rng.integers(1, d["promo"] + 1, n), 0.1),
        "ws_order_number": (np.arange(n, dtype=np.int64) // 3 + 1),
        "ws_quantity": qty.astype(np.int64),
        "ws_wholesale_cost": m["wholesale"],
        "ws_list_price": m["list"],
        "ws_sales_price": m["sales"],
        "ws_ext_discount_amt": m["ext_discount"],
        "ws_ext_sales_price": m["ext_sales"],
        "ws_ext_wholesale_cost": m["ext_wholesale"],
        "ws_ext_list_price": m["ext_list"],
        "ws_ext_tax": m["tax"],
        "ws_coupon_amt": m["coupon"],
        "ws_ext_ship_cost": ship_cost,
        "ws_net_paid": m["net_paid"],
        "ws_net_paid_inc_tax": m["net_paid_tax"],
        "ws_net_paid_inc_ship": np.round(m["net_paid"] + ship_cost, 2),
        "ws_net_paid_inc_ship_tax": np.round(
            m["net_paid_tax"] + ship_cost, 2
        ),
        "ws_net_profit": m["net_profit"],
    })


def _gen_web_returns(sf, rng, web_sales: HostBatch) -> HostBatch:
    def build(sample: HostBatch, idx) -> HostBatch:
        n = sample.num_rows
        sold = _ints_or(sample, "ws_sold_date_sk", SK_BASE)
        ret_day = np.minimum(sold + rng.integers(1, 90, n), SK_BASE + N_DATES - 1)
        qty_sold = _col(sample, "ws_quantity").data.astype(np.int64)
        ret_qty = np.maximum(1, (qty_sold * rng.uniform(0.1, 1.0, n)).astype(np.int64))
        sales_price = _col(sample, "ws_sales_price").data.astype(np.float64)
        amt = np.round(sales_price * ret_qty, 2)
        tax = np.round(amt * 0.05, 2)
        fee = _money(rng, 0.5, 100.0, n)
        ship = _money(rng, 0.0, 50.0, n)
        refunded = np.round(amt * rng.uniform(0.3, 1.0, n), 2)
        reversed_ = np.round((amt - refunded) * 0.5, 2)
        return _table({
            "wr_returned_date_sk": _nullable(ret_day, LONG),
            "wr_returned_time_sk": (rng.integers(0, 1440, n) * 60).astype(np.int64),
            "wr_item_sk": _col(sample, "ws_item_sk"),
            "wr_refunded_customer_sk": _col(sample, "ws_bill_customer_sk"),
            "wr_refunded_cdemo_sk": _col(sample, "ws_bill_cdemo_sk"),
            "wr_refunded_hdemo_sk": _col(sample, "ws_bill_hdemo_sk"),
            "wr_refunded_addr_sk": _col(sample, "ws_bill_addr_sk"),
            "wr_returning_customer_sk": _col(sample, "ws_ship_customer_sk"),
            "wr_returning_cdemo_sk": _col(sample, "ws_ship_cdemo_sk"),
            "wr_returning_hdemo_sk": _col(sample, "ws_ship_hdemo_sk"),
            "wr_returning_addr_sk": _col(sample, "ws_ship_addr_sk"),
            "wr_web_page_sk": _col(sample, "ws_web_page_sk"),
            "wr_reason_sk": rng.integers(1, len(REASONS) + 1, n).astype(np.int64),
            "wr_order_number": _col(sample, "ws_order_number"),
            "wr_return_quantity": ret_qty,
            "wr_return_amt": amt,
            "wr_return_tax": tax,
            "wr_return_amt_inc_tax": np.round(amt + tax, 2),
            "wr_fee": fee,
            "wr_return_ship_cost": ship,
            "wr_refunded_cash": refunded,
            "wr_reversed_charge": reversed_,
            "wr_account_credit": np.round(amt - refunded - reversed_, 2),
            "wr_net_loss": np.round(amt * 0.1 + fee + ship, 2),
        })

    return _returns_from(web_sales, rng, 0.1, {}, build)


def _gen_inventory(sf, rng) -> HostBatch:
    d = _fact_dims(sf)
    # weekly snapshots x (item, warehouse) sample, spec-shaped
    weeks = np.arange(_days(1998, 1, 2), _days(2002, 12, 31), 7, dtype=np.int64)
    target = _n("inventory", sf, linear=True)
    per_week = max(1, target // len(weeks))
    rows_d, rows_i, rows_w, rows_q = [], [], [], []
    for wday in weeks:
        items = rng.integers(1, d["item"] + 1, per_week)
        whs = rng.integers(1, d["warehouse"] + 1, per_week)
        qty = rng.integers(0, 1001, per_week)
        rows_d.append(np.full(per_week, wday, np.int64))
        rows_i.append(items)
        rows_w.append(whs)
        rows_q.append(qty)
    return _table({
        "inv_date_sk": _sk(np.concatenate(rows_d)).astype(np.int64),
        "inv_item_sk": np.concatenate(rows_i).astype(np.int64),
        "inv_warehouse_sk": np.concatenate(rows_w).astype(np.int64),
        "inv_quantity_on_hand": np.concatenate(rows_q).astype(np.int64),
    })


# ── public API ─────────────────────────────────────────────────────────────

_CACHE: Dict = {}


def gen_table(name: str, sf: float, seed: int = 20030101) -> HostBatch:
    """Generate one TPC-DS table at scale factor ``sf`` (deterministic)."""
    key = (name, sf, seed)
    if key in _CACHE:
        return _CACHE[key]
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, TABLES.index(name), int(sf * 1e6)])
    )
    if name == "date_dim":
        t = _gen_date_dim(sf, rng)
    elif name == "time_dim":
        t = _gen_time_dim(sf, rng)
    elif name == "item":
        t = _gen_item(sf, rng)
    elif name == "customer":
        d = _fact_dims(sf)
        t = _gen_customer(sf, rng, d["cd"], d["hd"], d["addr"])
    elif name == "customer_address":
        t = _gen_customer_address(sf, rng)
    elif name == "customer_demographics":
        t = _gen_customer_demographics(sf, rng)
    elif name == "household_demographics":
        t = _gen_household_demographics(sf, rng)
    elif name == "income_band":
        t = _gen_income_band(sf, rng)
    elif name == "store":
        t = _gen_store(sf, rng)
    elif name == "warehouse":
        t = _gen_warehouse(sf, rng)
    elif name == "call_center":
        t = _gen_call_center(sf, rng)
    elif name == "web_site":
        t = _gen_web_site(sf, rng)
    elif name == "web_page":
        t = _gen_web_page(sf, rng)
    elif name == "catalog_page":
        t = _gen_catalog_page(sf, rng)
    elif name == "promotion":
        t = _gen_promotion(sf, rng, _fact_dims(sf)["item"])
    elif name == "reason":
        t = _gen_reason(sf, rng)
    elif name == "ship_mode":
        t = _gen_ship_mode(sf, rng)
    elif name == "store_sales":
        t = _gen_store_sales(sf, rng)
    elif name == "store_returns":
        t = _gen_store_returns(sf, rng, gen_table("store_sales", sf, seed))
    elif name == "catalog_sales":
        t = _gen_catalog_sales(sf, rng)
    elif name == "catalog_returns":
        t = _gen_catalog_returns(sf, rng, gen_table("catalog_sales", sf, seed))
    elif name == "web_sales":
        t = _gen_web_sales(sf, rng)
    elif name == "web_returns":
        t = _gen_web_returns(sf, rng, gen_table("web_sales", sf, seed))
    elif name == "inventory":
        t = _gen_inventory(sf, rng)
    else:
        raise KeyError(name)
    _CACHE[key] = t
    return t


def register_tables(session, sf: float, seed: int = 20030101,
                    num_partitions: int = 1) -> None:
    """Register all 24 tables as temp views on a session."""
    for name in TABLES:
        t = gen_table(name, sf, seed)
        n = num_partitions if t.num_rows > 5000 else 1
        session.create_dataframe(t, num_partitions=n).create_or_replace_temp_view(
            name
        )
