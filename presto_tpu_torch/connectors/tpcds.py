"""TPC-DS data generator — columnar, vectorized, deterministic.

This is the torch package's copy of presto_tpu/connectors/tpcds.py: the
same numpy generator with the same seeds, so it yields the same rows bit
for bit and TpcdsCatalog(sf) is the same data in both packages. Pages land
on the catalog's device ("cuda" unless the caller passes device="cpu").

Re-designed equivalent of the reference's presto-tpcds connector
(presto-tpcds/src/main/java/com/facebook/presto/tpcds/ — TpcdsMetadata,
TpcdsRecordSet over the teradata dsdgen port, with statistics under
tpcds/statistics/). Follows the same approach as connectors/tpch.py: all 24
spec tables with spec column names/types and spec-shaped distributions,
generated as single-pass numpy columns. Values match the SQLite oracle (the
oracle loads the same generated data), not binary dsdgen output — that is
the correctness contract for engine tests, exactly as with the TPC-H
generator (see tpch.py module docstring).

Sizing follows the spec's SF1 row counts (§3.2 scaling), scaled linearly;
fixed-size dimensions (date_dim, time_dim, ship_mode, income_band) stay
fixed except the two demographics cross-product tables, which are sampled
down at small SF so tests stay fast.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .. import types as T
from .tpch import Column, Table

D72 = T.DecimalType(7, 2)
D52 = T.DecimalType(5, 2)

# ---------------------------------------------------------------------------
# calendar: date_dim is a REAL calendar (queries filter d_year/d_moy/d_dow)
# ---------------------------------------------------------------------------

_D_BASE = np.datetime64("1900-01-01")
_D_END = np.datetime64("2100-01-01")
_N_DATES = int((_D_END - _D_BASE).astype(int)) + 1  # 73050 days; spec 73049
_EPOCH = np.datetime64("1970-01-01")

# sales activity window: date_sks for 1998-01-01 .. 2002-12-31 (spec §5)
_SALES_LO = int((np.datetime64("1998-01-01") - _D_BASE).astype(int))
_SALES_HI = int((np.datetime64("2003-01-01") - _D_BASE).astype(int))

_DAY_NAMES = (
    "Friday", "Monday", "Saturday", "Sunday", "Thursday", "Tuesday",
    "Wednesday",
)
_DAY_CODE = {
    name: i for i, name in enumerate(_DAY_NAMES)
}  # dictionary sorted
_WEEKDAY_TO_NAME = [
    "Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday",
    "Sunday",
]

_CATEGORIES = (
    "Books", "Children", "Electronics", "Home", "Jewelry", "Men", "Music",
    "Shoes", "Sports", "Women",
)
_CLASSES = tuple(
    sorted(
        {
            f"{c.lower()} class {i:02d}"
            for c in _CATEGORIES
            for i in range(1, 6)
        }
    )
)
_STATES = (
    "AL", "AR", "AZ", "CA", "CO", "FL", "GA", "IA", "IL", "IN", "KS", "KY",
    "LA", "MI", "MN", "MO", "MS", "NC", "ND", "NE", "NJ", "NM", "NY", "OH",
    "OK", "OR", "PA", "SC", "SD", "TN", "TX", "UT", "VA", "WA", "WI", "WV",
)
_CITIES = tuple(
    sorted(
        {
            f"{a} {b}"
            for a in ("Oak", "Cedar", "Pine", "Maple", "Spring", "Center",
                      "Fair", "Green", "River", "Union")
            for b in ("Grove", "Hill", "Ridge", "Creek", "Park", "View",
                      "town", "ville", "dale", "field")
        }
    )
)
_COUNTIES = tuple(sorted({f"{c} County" for c in _CITIES[:60]}))
_STREET_TYPES = ("Ave", "Blvd", "Cir", "Ct", "Dr", "Ln", "Pkwy", "RD",
                 "ST", "Way")
_STREET_NAMES = tuple(
    sorted(
        {
            f"{a} {b}"
            for a in ("First", "Second", "Third", "Fourth", "Fifth", "Main",
                      "Park", "Lake", "Hill", "Elm")
            for b in ("", "North", "South", "East", "West")
        }
    )
)
_GENDERS = ("F", "M")
_MARITAL = ("D", "M", "S", "U", "W")
_EDUCATION = (
    "2 yr Degree", "4 yr Degree", "Advanced Degree", "College", "Primary",
    "Secondary", "Unknown",
)
_CREDIT = ("Good", "High Risk", "Low Risk", "Unknown")
_BUY_POTENTIAL = (
    "0-500", "1001-5000", "501-1000", "5001-10000", ">10000", "Unknown",
)
_SALUTATIONS = ("Dr.", "Miss", "Mr.", "Mrs.", "Ms.", "Sir")
_FIRST_NAMES = tuple(
    sorted(
        {
            "James", "Mary", "John", "Patricia", "Robert", "Jennifer",
            "Michael", "Linda", "William", "Barbara", "David", "Susan",
            "Richard", "Jessica", "Joseph", "Sarah", "Thomas", "Karen",
            "Charles", "Nancy", "Daniel", "Lisa", "Matthew", "Betty",
            "Anthony", "Helen", "Mark", "Sandra", "Paul", "Donna",
        }
    )
)
_LAST_NAMES = tuple(
    sorted(
        {
            "Smith", "Johnson", "Williams", "Brown", "Jones", "Garcia",
            "Miller", "Davis", "Rodriguez", "Martinez", "Hernandez",
            "Lopez", "Gonzalez", "Wilson", "Anderson", "Thomas", "Taylor",
            "Moore", "Jackson", "Martin", "Lee", "Perez", "Thompson",
            "White", "Harris", "Sanchez", "Clark", "Ramirez", "Lewis",
            "Robinson",
        }
    )
)
_COUNTRIES = ("United States",)
_COLORS = (
    "almond", "azure", "beige", "black", "blue", "brown", "coral", "cream",
    "cyan", "forest", "gold", "green", "grey", "indigo", "ivory", "khaki",
    "lace", "lime", "maroon", "metallic", "navy", "olive", "orange",
    "orchid", "pale", "peach", "pink", "plum", "powder", "puff", "purple",
    "red", "rose", "royal", "salmon", "sienna", "sky", "slate", "smoke",
    "snow", "spring", "steel", "tan", "thistle", "tomato", "turquoise",
    "violet", "wheat", "white", "yellow",
)
_UNITS = ("Box", "Bunch", "Bundle", "Carton", "Case", "Cup", "Dozen",
          "Dram", "Each", "Gram", "Gross", "Lb", "N/A", "Ounce", "Oz",
          "Pallet", "Pound", "Tbl", "Ton", "Unknown")
_SHIP_MODE_TYPES = ("EXPRESS", "LIBRARY", "NEXT DAY", "OVERNIGHT",
                    "REGULAR", "TWO DAY")
_SHIP_MODE_CODES = ("AIR", "GROUND", "SEA")
_CARRIERS = ("AIRBORNE", "ALLIANCE", "BARIAN", "BOXBUNDLES", "DHL",
             "DIAMOND", "FEDEX", "GERMA", "GREAT EASTERN", "HARMSTORF",
             "LATVIAN", "MSC", "ORIENTAL", "PRIVATECARRIER", "RUPEKSA",
             "TBS", "UPS", "USPS", "ZHOU", "ZOUROS")
_REASONS = tuple(
    sorted(
        {
            "Did not fit", "Did not get it on time", "Did not like the color",
            "Did not like the model", "Did not like the warranty",
            "Found a better price", "Gift exchange", "Item was damaged",
            "Lost my job", "No longer needed", "Not the product that was "
            "ordred", "Parts missing", "Stopped working", "Wrong size",
            "unauthoized purchase", "duplicate purchase", "its is a boy",
            "its is a girl",
        }
    )
)
_MEALS = ("breakfast", "dinner", "lunch", "")
_SHIFTS = ("first", "second", "third")
_AMPM = ("AM", "PM")


def _ids(prefix: str, n: int, width: int = 16):
    """Business-key id strings ('AAAAAAAA...'-style in dsdgen; here a
    zero-padded sorted pool so codes==order)."""
    dictionary = tuple(f"{prefix}{i:0{width}d}" for i in range(n))
    return Column(np.arange(n, dtype=np.int32), T.VARCHAR, dictionary)


def _pool(rng, n, pool) -> Column:
    pool = tuple(pool)
    return Column(rng.integers(0, len(pool), n).astype(np.int32), T.VARCHAR, pool)


def _dec(arr, scale=2, precision=7) -> Column:
    return Column(
        np.asarray(arr).astype(np.int64), T.DecimalType(precision, scale)
    )


def _sk(arr, valid=None) -> Column:
    return Column(np.asarray(arr).astype(np.int64), T.BIGINT, None, valid)


def _sk_nullable(arr, rng, frac=0.04) -> Column:
    """Fact FK with a NULL fraction (dsdgen leaves a few % of fact foreign
    keys null; Q76 aggregates exactly those rows)."""
    a = np.asarray(arr)
    return _sk(a, valid=rng.random(len(a)) >= frac)


def _int(arr) -> Column:
    return Column(np.asarray(arr).astype(np.int64), T.BIGINT)


def _scaled(base: int, sf: float, lo: int = 1) -> int:
    return max(int(base * sf), lo)


# ---------------------------------------------------------------------------
# dimensions
# ---------------------------------------------------------------------------


def gen_date_dim() -> Table:
    n = _N_DATES
    dates = _D_BASE + np.arange(n)
    days_since_epoch = (dates - _EPOCH).astype(int)
    y = dates.astype("datetime64[Y]").astype(int) + 1970
    month0 = dates.astype("datetime64[M]").astype(int)
    moy = month0 % 12 + 1
    dom = (dates - dates.astype("datetime64[M]")).astype(int) + 1
    qoy = (moy - 1) // 3 + 1
    # numpy weekday: day 0 (1970-01-01) was Thursday; dsdgen d_dow has
    # Sunday=0 — any fixed convention works, the oracle sees the same data
    weekday = (days_since_epoch + 3) % 7  # 0=Monday .. 6=Sunday
    dow = (weekday + 1) % 7  # 0=Sunday .. 6=Saturday
    day_codes = np.array(
        [_DAY_CODE[_WEEKDAY_TO_NAME[w]] for w in range(7)], np.int32
    )[weekday]
    month_seq = month0 - (1900 - 1970) * 12
    week_seq = (days_since_epoch - (int((_D_BASE - _EPOCH).astype(int)))) // 7
    quarter_names = tuple(
        sorted({f"{yy}Q{q}" for yy in range(1900, 2101) for q in (1, 2, 3, 4)})
    )
    qname_index = {s: i for i, s in enumerate(quarter_names)}
    qname_codes = np.array(
        [qname_index[f"{yy}Q{qq}"] for yy, qq in zip(y, qoy)], np.int32
    )
    first_dom = days_since_epoch - (dom - 1)
    month_len = np.array(
        (
            (dates.astype("datetime64[M]") + 1).astype("datetime64[D]")
            - dates.astype("datetime64[M]").astype("datetime64[D]")
        ).astype(int)
    )
    last_dom = first_dom + month_len - 1
    holiday = ((moy == 12) & (dom == 25)) | ((moy == 7) & (dom == 4)) | (
        (moy == 1) & (dom == 1)
    )
    weekend = weekday >= 5
    yn = ("N", "Y")
    return Table(
        "date_dim",
        {
            "d_date_sk": _sk(np.arange(n)),
            "d_date_id": _ids("D", n),
            "d_date": Column(days_since_epoch.astype(np.int32), T.DATE),
            "d_month_seq": _int(month_seq),
            "d_week_seq": _int(week_seq),
            "d_quarter_seq": _int((y - 1900) * 4 + qoy - 1),
            "d_year": _int(y),
            "d_dow": _int(dow),
            "d_moy": _int(moy),
            "d_dom": _int(dom),
            "d_qoy": _int(qoy),
            "d_fy_year": _int(y),
            "d_fy_quarter_seq": _int((y - 1900) * 4 + qoy - 1),
            "d_fy_week_seq": _int(week_seq),
            "d_day_name": Column(day_codes, T.VARCHAR, _DAY_NAMES),
            "d_quarter_name": Column(qname_codes, T.VARCHAR, quarter_names),
            "d_holiday": Column(
                holiday.astype(np.int32), T.VARCHAR, yn
            ),
            "d_weekend": Column(weekend.astype(np.int32), T.VARCHAR, yn),
            "d_following_holiday": Column(
                np.roll(holiday, -1).astype(np.int32), T.VARCHAR, yn
            ),
            "d_first_dom": _int(first_dom),
            "d_last_dom": _int(last_dom),
            "d_same_day_ly": _int(days_since_epoch - 365),
            "d_same_day_lq": _int(days_since_epoch - 91),
            "d_current_day": Column(np.zeros(n, np.int32), T.VARCHAR, yn),
            "d_current_week": Column(np.zeros(n, np.int32), T.VARCHAR, yn),
            "d_current_month": Column(np.zeros(n, np.int32), T.VARCHAR, yn),
            "d_current_quarter": Column(np.zeros(n, np.int32), T.VARCHAR, yn),
            "d_current_year": Column(np.zeros(n, np.int32), T.VARCHAR, yn),
        },
    )


def gen_time_dim() -> Table:
    n = 86400
    t = np.arange(n)
    hour = t // 3600
    minute = (t // 60) % 60
    second = t % 60
    shifts = tuple(sorted(_SHIFTS))  # ('first','second','third')
    # first: 8-16, second: 16-24, third: 0-8
    shift_codes = np.where(
        (hour >= 8) & (hour < 16),
        shifts.index("first"),
        np.where(hour >= 16, shifts.index("second"), shifts.index("third")),
    ).astype(np.int32)
    meals = tuple(sorted(set(_MEALS)))
    meal_codes = np.select(
        [
            (hour >= 6) & (hour < 9),
            (hour >= 11) & (hour < 13),
            (hour >= 17) & (hour < 20),
        ],
        [
            meals.index("breakfast"),
            meals.index("lunch"),
            meals.index("dinner"),
        ],
        meals.index(""),
    ).astype(np.int32)
    return Table(
        "time_dim",
        {
            "t_time_sk": _sk(t),
            "t_time_id": _ids("T", n),
            "t_time": _int(t),
            "t_hour": _int(hour),
            "t_minute": _int(minute),
            "t_second": _int(second),
            "t_am_pm": Column(
                (hour >= 12).astype(np.int32), T.VARCHAR, _AMPM
            ),
            "t_shift": Column(shift_codes, T.VARCHAR, shifts),
            "t_sub_shift": Column(shift_codes, T.VARCHAR, shifts),
            "t_meal_time": Column(meal_codes, T.VARCHAR, meals),
        },
    )


def gen_item(sf: float) -> Table:
    n = _scaled(18_000, sf, lo=100)
    rng = np.random.default_rng(7001)
    cat = rng.integers(0, len(_CATEGORIES), n)
    class_in_cat = rng.integers(1, 6, n)
    class_names = np.array(
        [
            f"{_CATEGORIES[c].lower()} class {k:02d}"
            for c, k in zip(cat, class_in_cat)
        ]
    )
    class_index = {s: i for i, s in enumerate(_CLASSES)}
    class_codes = np.array([class_index[s] for s in class_names], np.int32)
    brand_id = (cat + 1) * 1_000_000 + class_in_cat * 1000 + rng.integers(1, 10, n)
    brands = tuple(sorted({f"brand{b:08d}" for b in np.unique(brand_id)}))
    bindex = {s: i for i, s in enumerate(brands)}
    brand_codes = np.array(
        [bindex[f"brand{b:08d}"] for b in brand_id], np.int32
    )
    manufact_id = rng.integers(1, 1001, n)
    manufacts = tuple(f"manufact{i:06d}" for i in range(1, 1001))
    price = rng.integers(100, 30000, n)
    wholesale = (price * rng.uniform(0.3, 0.8, n)).astype(np.int64)
    start = int((np.datetime64("1997-01-01") - _EPOCH).astype(int))
    desc_pool = tuple(
        sorted(
            {
                f"{a} {b} {c}"
                for a in ("Durable", "Shiny", "Compact", "Modern", "Classic",
                          "Premium", "Basic", "Deluxe")
                for b in ("red", "blue", "steel", "wooden", "plastic",
                          "ceramic")
                for c in ("gadget", "tool", "device", "kit", "set", "pack")
            }
        )
    )
    return Table(
        "item",
        {
            "i_item_sk": _sk(np.arange(n)),
            "i_item_id": _ids("I", n),
            "i_rec_start_date": Column(
                np.full(n, start, np.int32), T.DATE
            ),
            "i_rec_end_date": Column(
                np.full(n, start + 3650, np.int32), T.DATE
            ),
            "i_item_desc": _pool(rng, n, desc_pool),
            "i_current_price": _dec(price),
            "i_wholesale_cost": _dec(wholesale),
            "i_brand_id": _int(brand_id),
            "i_brand": Column(brand_codes, T.VARCHAR, brands),
            "i_class_id": _int(class_in_cat),
            "i_class": Column(class_codes, T.VARCHAR, _CLASSES),
            "i_category_id": _int(cat + 1),
            "i_category": Column(cat.astype(np.int32), T.VARCHAR, _CATEGORIES),
            "i_manufact_id": _int(manufact_id),
            "i_manufact": Column(
                (manufact_id - 1).astype(np.int32), T.VARCHAR, manufacts
            ),
            "i_size": _pool(rng, n, ("N/A", "economy", "extra large",
                                     "large", "medium", "petite", "small")),
            "i_formulation": _pool(rng, n, tuple(f"form{i:04d}" for i in range(200))),
            "i_color": _pool(rng, n, _COLORS),
            "i_units": _pool(rng, n, _UNITS),
            "i_container": _pool(rng, n, ("Unknown",)),
            "i_manager_id": _int(rng.integers(1, 101, n)),
            "i_product_name": _ids("product", n),
        },
    )


def gen_customer_address(sf: float) -> Table:
    n = _scaled(50_000, sf, lo=200)
    rng = np.random.default_rng(7002)
    zips = tuple(f"{z:05d}" for z in range(100, 100 + 2000))
    return Table(
        "customer_address",
        {
            "ca_address_sk": _sk(np.arange(n)),
            "ca_address_id": _ids("A", n),
            "ca_street_number": _pool(
                rng, n, tuple(str(i) for i in range(1, 1000))
            ),
            "ca_street_name": _pool(rng, n, _STREET_NAMES),
            "ca_street_type": _pool(rng, n, _STREET_TYPES),
            "ca_suite_number": _pool(
                rng, n, tuple(f"Suite {i}" for i in range(100))
            ),
            "ca_city": _pool(rng, n, _CITIES),
            "ca_county": _pool(rng, n, _COUNTIES),
            "ca_state": _pool(rng, n, _STATES),
            "ca_zip": _pool(rng, n, zips),
            "ca_country": _pool(rng, n, _COUNTRIES),
            "ca_gmt_offset": _dec(
                rng.choice([-500, -600, -700, -800], n), 2, 5
            ),
            "ca_location_type": _pool(
                rng, n, ("apartment", "condo", "single family")
            ),
        },
    )


def gen_customer_demographics(sf: float) -> Table:
    # spec: fixed 1,920,800-row cross product; sampled down for small SF
    # (kept a cross-product enumeration so every attribute combination
    # that appears is self-consistent)
    n = min(1_920_800, _scaled(1_920_800, min(sf, 1.0), lo=2000))
    idx = np.arange(n, dtype=np.int64)
    g = idx % 2
    ms = (idx // 2) % 5
    ed = (idx // 10) % 7
    pe = (idx // 70) % 20
    cr = (idx // 1400) % 4
    dep = (idx // 5600) % 7
    demp = (idx // 39200) % 7
    dcol = (idx // 274400) % 7
    return Table(
        "customer_demographics",
        {
            "cd_demo_sk": _sk(idx),
            "cd_gender": Column(g.astype(np.int32), T.VARCHAR, _GENDERS),
            "cd_marital_status": Column(
                ms.astype(np.int32), T.VARCHAR, _MARITAL
            ),
            "cd_education_status": Column(
                ed.astype(np.int32), T.VARCHAR, _EDUCATION
            ),
            "cd_purchase_estimate": _int(500 * (pe + 1)),
            "cd_credit_rating": Column(
                cr.astype(np.int32), T.VARCHAR, _CREDIT
            ),
            "cd_dep_count": _int(dep),
            "cd_dep_employed_count": _int(demp),
            "cd_dep_college_count": _int(dcol),
        },
    )


def gen_household_demographics() -> Table:
    n = 7200
    idx = np.arange(n, dtype=np.int64)
    ib = idx % 20
    bp = (idx // 20) % 6
    dep = (idx // 120) % 10
    veh = (idx // 1200) % 6
    pots = tuple(sorted(_BUY_POTENTIAL))
    return Table(
        "household_demographics",
        {
            "hd_demo_sk": _sk(idx),
            "hd_income_band_sk": _sk(ib),
            "hd_buy_potential": Column(
                np.array(
                    [pots.index(_BUY_POTENTIAL[b]) for b in bp], np.int32
                ),
                T.VARCHAR,
                pots,
            ),
            "hd_dep_count": _int(dep),
            "hd_vehicle_count": _int(veh - 1),
        },
    )


def gen_income_band() -> Table:
    n = 20
    lo = np.arange(n, dtype=np.int64) * 10000
    return Table(
        "income_band",
        {
            "ib_income_band_sk": _sk(np.arange(n)),
            "ib_lower_bound": _int(lo + 1),
            "ib_upper_bound": _int(lo + 10000),
        },
    )


def gen_customer(sf: float) -> Table:
    n = _scaled(100_000, sf, lo=500)
    n_addr = _scaled(50_000, sf, lo=200)
    n_cd = min(1_920_800, _scaled(1_920_800, min(sf, 1.0), lo=2000))
    rng = np.random.default_rng(7003)
    first_sales = rng.integers(_SALES_LO - 3650, _SALES_LO, n)
    return Table(
        "customer",
        {
            "c_customer_sk": _sk(np.arange(n)),
            "c_customer_id": _ids("C", n),
            "c_current_cdemo_sk": _sk(rng.integers(0, n_cd, n)),
            "c_current_hdemo_sk": _sk(rng.integers(0, 7200, n)),
            "c_current_addr_sk": _sk(rng.integers(0, n_addr, n)),
            "c_first_shipto_date_sk": _sk(first_sales + 30),
            "c_first_sales_date_sk": _sk(first_sales),
            "c_salutation": _pool(rng, n, _SALUTATIONS),
            "c_first_name": _pool(rng, n, _FIRST_NAMES),
            "c_last_name": _pool(rng, n, _LAST_NAMES),
            "c_preferred_cust_flag": _pool(rng, n, ("N", "Y")),
            "c_birth_day": _int(rng.integers(1, 29, n)),
            "c_birth_month": _int(rng.integers(1, 13, n)),
            "c_birth_year": _int(rng.integers(1930, 1993, n)),
            # dsdgen stores birth country UPPERCASE (Q24 joins it against
            # upper(ca_country))
            "c_birth_country": _pool(
                rng, n, tuple(c.upper() for c in _COUNTRIES)
            ),
            "c_login": _ids("login", n),
            "c_email_address": _ids("email", n),
            "c_last_review_date_sk": _sk(
                rng.integers(_SALES_LO, _SALES_HI, n)
            ),
        },
    )


def gen_store(sf: float) -> Table:
    n = _scaled(12, sf, lo=4)
    rng = np.random.default_rng(7004)
    # dsdgen-style syllable store names (queries filter on e.g. 'ese')
    names = ("able", "anti", "ation", "bar", "cally", "eing", "ese", "ought")
    return Table(
        "store",
        {
            "s_store_sk": _sk(np.arange(n)),
            "s_store_id": _ids("S", n),
            "s_rec_start_date": Column(
                np.full(n, _SALES_LO - 3650, np.int32) * 0
                + int((np.datetime64("1997-03-13") - _EPOCH).astype(int)),
                T.DATE,
            ),
            "s_rec_end_date": Column(
                np.full(
                    n,
                    int((np.datetime64("2001-03-13") - _EPOCH).astype(int)),
                    np.int32,
                ),
                T.DATE,
            ),
            "s_closed_date_sk": _sk(np.zeros(n)),
            "s_store_name": Column(
                np.arange(n, dtype=np.int32) % len(names), T.VARCHAR, names
            ),
            "s_number_employees": _int(rng.integers(200, 301, n)),
            "s_floor_space": _int(rng.integers(5_000_000, 10_000_001, n)),
            "s_hours": _pool(rng, n, ("8AM-12AM", "8AM-4PM", "8AM-8AM")),
            "s_manager": _pool(rng, n, _LAST_NAMES),
            "s_market_id": _int(rng.integers(1, 11, n)),
            "s_geography_class": _pool(rng, n, ("Unknown",)),
            "s_market_desc": _pool(rng, n, ("Unknown",)),
            "s_market_manager": _pool(rng, n, _LAST_NAMES),
            "s_division_id": _int(np.ones(n)),
            "s_division_name": _pool(rng, n, ("Unknown",)),
            "s_company_id": _int(np.ones(n)),
            "s_company_name": _pool(rng, n, ("Unknown",)),
            "s_street_number": _pool(
                rng, n, tuple(str(i) for i in range(1, 1000))
            ),
            "s_street_name": _pool(rng, n, _STREET_NAMES),
            "s_street_type": _pool(rng, n, _STREET_TYPES),
            "s_suite_number": _pool(
                rng, n, tuple(f"Suite {i}" for i in range(100))
            ),
            "s_city": _pool(rng, n, _CITIES),
            "s_county": _pool(rng, n, _COUNTIES),
            "s_state": _pool(rng, n, _STATES[:8]),
            "s_zip": _pool(rng, n, tuple(f"{z:05d}" for z in range(100, 600))),
            "s_country": _pool(rng, n, _COUNTRIES),
            "s_gmt_offset": _dec(rng.choice([-500, -600], n), 2, 5),
            "s_tax_precentage": _dec(rng.integers(0, 12, n), 2, 5),
        },
    )


def gen_warehouse(sf: float) -> Table:
    n = _scaled(5, sf, lo=3)
    rng = np.random.default_rng(7005)
    return Table(
        "warehouse",
        {
            "w_warehouse_sk": _sk(np.arange(n)),
            "w_warehouse_id": _ids("W", n),
            "w_warehouse_name": _ids("warehouse", n),
            "w_warehouse_sq_ft": _int(rng.integers(50_000, 1_000_000, n)),
            "w_street_number": _pool(
                rng, n, tuple(str(i) for i in range(1, 1000))
            ),
            "w_street_name": _pool(rng, n, _STREET_NAMES),
            "w_street_type": _pool(rng, n, _STREET_TYPES),
            "w_suite_number": _pool(
                rng, n, tuple(f"Suite {i}" for i in range(100))
            ),
            "w_city": _pool(rng, n, _CITIES),
            "w_county": _pool(rng, n, _COUNTIES),
            "w_state": _pool(rng, n, _STATES[:8]),
            "w_zip": _pool(rng, n, tuple(f"{z:05d}" for z in range(100, 600))),
            "w_country": _pool(rng, n, _COUNTRIES),
            "w_gmt_offset": _dec(rng.choice([-500, -600], n), 2, 5),
        },
    )


def gen_ship_mode() -> Table:
    n = 20
    rng = np.random.default_rng(7006)
    types = tuple(sorted(_SHIP_MODE_TYPES))
    codes = tuple(sorted(_SHIP_MODE_CODES))
    return Table(
        "ship_mode",
        {
            "sm_ship_mode_sk": _sk(np.arange(n)),
            "sm_ship_mode_id": _ids("SM", n),
            "sm_type": Column(
                (np.arange(n) % len(types)).astype(np.int32), T.VARCHAR, types
            ),
            "sm_code": Column(
                (np.arange(n) % len(codes)).astype(np.int32), T.VARCHAR, codes
            ),
            "sm_carrier": Column(
                np.arange(n, dtype=np.int32), T.VARCHAR, _CARRIERS
            ),
            "sm_contract": _pool(rng, n, tuple(f"contract{i}" for i in range(20))),
        },
    )


def gen_reason() -> Table:
    n = len(_REASONS)
    return Table(
        "reason",
        {
            "r_reason_sk": _sk(np.arange(n)),
            "r_reason_id": _ids("R", n),
            "r_reason_desc": Column(
                np.arange(n, dtype=np.int32), T.VARCHAR, _REASONS
            ),
        },
    )


def gen_promotion(sf: float) -> Table:
    n = _scaled(300, sf, lo=30)
    rng = np.random.default_rng(7007)
    yn = ("N", "Y")
    start = rng.integers(_SALES_LO, _SALES_HI - 60, n)
    channels = {
        ch: Column(rng.integers(0, 2, n).astype(np.int32), T.VARCHAR, yn)
        for ch in (
            "p_channel_dmail", "p_channel_email", "p_channel_catalog",
            "p_channel_tv", "p_channel_radio", "p_channel_press",
            "p_channel_event", "p_channel_demo",
        )
    }
    return Table(
        "promotion",
        {
            "p_promo_sk": _sk(np.arange(n)),
            "p_promo_id": _ids("P", n),
            "p_start_date_sk": _sk(start),
            "p_end_date_sk": _sk(start + rng.integers(10, 60, n)),
            "p_item_sk": _sk(
                rng.integers(0, _scaled(18_000, sf, lo=100), n)
            ),
            "p_cost": _dec(rng.integers(50000, 300001, n), 2, 15),
            "p_response_target": _int(np.ones(n)),
            "p_promo_name": _pool(
                rng, n, ("able", "ation", "bar", "ese", "eing", "ought",
                         "anti", "cally", "ition", "pri")
            ),
            **channels,
            "p_channel_details": _ids("promo details ", n),
            "p_purpose": _pool(rng, n, ("Unknown",)),
            "p_discount_active": Column(
                rng.integers(0, 2, n).astype(np.int32), T.VARCHAR, yn
            ),
        },
    )


def gen_web_site(sf: float) -> Table:
    n = _scaled(30, sf, lo=5)
    rng = np.random.default_rng(7008)
    return Table(
        "web_site",
        {
            "web_site_sk": _sk(np.arange(n)),
            "web_site_id": _ids("WEB", n),
            "web_rec_start_date": Column(
                np.full(
                    n,
                    int((np.datetime64("1997-08-16") - _EPOCH).astype(int)),
                    np.int32,
                ),
                T.DATE,
            ),
            "web_rec_end_date": Column(
                np.full(
                    n,
                    int((np.datetime64("2001-08-16") - _EPOCH).astype(int)),
                    np.int32,
                ),
                T.DATE,
            ),
            "web_name": _pool(rng, n, tuple(f"site_{i}" for i in range(30))),
            "web_open_date_sk": _sk(rng.integers(_SALES_LO - 3650, _SALES_LO, n)),
            "web_close_date_sk": _sk(np.full(n, _SALES_HI + 1000)),
            "web_class": _pool(rng, n, ("Unknown",)),
            "web_manager": _pool(rng, n, _LAST_NAMES),
            "web_mkt_id": _int(rng.integers(1, 7, n)),
            "web_mkt_class": _pool(rng, n, ("Unknown",)),
            "web_mkt_desc": _pool(rng, n, ("Unknown",)),
            "web_market_manager": _pool(rng, n, _LAST_NAMES),
            "web_company_id": _int(rng.integers(1, 7, n)),
            "web_company_name": _pool(
                rng, n, ("able", "ation", "bar", "ese", "eing", "ought")
            ),
            "web_street_number": _pool(
                rng, n, tuple(str(i) for i in range(1, 1000))
            ),
            "web_street_name": _pool(rng, n, _STREET_NAMES),
            "web_street_type": _pool(rng, n, _STREET_TYPES),
            "web_suite_number": _pool(
                rng, n, tuple(f"Suite {i}" for i in range(100))
            ),
            "web_city": _pool(rng, n, _CITIES),
            "web_county": _pool(rng, n, _COUNTIES),
            "web_state": _pool(rng, n, _STATES[:8]),
            "web_zip": _pool(rng, n, tuple(f"{z:05d}" for z in range(100, 600))),
            "web_country": _pool(rng, n, _COUNTRIES),
            "web_gmt_offset": _dec(rng.choice([-500, -600], n), 2, 5),
            "web_tax_percentage": _dec(rng.integers(0, 12, n), 2, 5),
        },
    )


def gen_web_page(sf: float) -> Table:
    n = _scaled(60, sf, lo=10)
    rng = np.random.default_rng(7009)
    yn = ("N", "Y")
    return Table(
        "web_page",
        {
            "wp_web_page_sk": _sk(np.arange(n)),
            "wp_web_page_id": _ids("WP", n),
            "wp_rec_start_date": Column(
                np.full(
                    n,
                    int((np.datetime64("1997-09-03") - _EPOCH).astype(int)),
                    np.int32,
                ),
                T.DATE,
            ),
            "wp_rec_end_date": Column(
                np.full(
                    n,
                    int((np.datetime64("2001-09-03") - _EPOCH).astype(int)),
                    np.int32,
                ),
                T.DATE,
            ),
            "wp_creation_date_sk": _sk(
                rng.integers(_SALES_LO - 365, _SALES_LO, n)
            ),
            "wp_access_date_sk": _sk(rng.integers(_SALES_LO, _SALES_HI, n)),
            "wp_autogen_flag": _pool(rng, n, yn),
            "wp_customer_sk": _sk(rng.integers(0, _scaled(100_000, sf, lo=500), n)),
            "wp_url": _pool(rng, n, ("http://www.foo.com",)),
            "wp_type": _pool(
                rng, n, ("ad", "dynamic", "feedback", "general", "order",
                         "protected", "welcome")
            ),
            "wp_char_count": _int(rng.integers(100, 8000, n)),
            "wp_link_count": _int(rng.integers(2, 25, n)),
            "wp_image_count": _int(rng.integers(1, 7, n)),
            "wp_max_ad_count": _int(rng.integers(0, 5, n)),
        },
    )


def gen_call_center(sf: float) -> Table:
    n = _scaled(6, sf, lo=2)
    rng = np.random.default_rng(7010)
    return Table(
        "call_center",
        {
            "cc_call_center_sk": _sk(np.arange(n)),
            "cc_call_center_id": _ids("CC", n),
            "cc_rec_start_date": Column(
                np.full(
                    n,
                    int((np.datetime64("1998-01-01") - _EPOCH).astype(int)),
                    np.int32,
                ),
                T.DATE,
            ),
            "cc_rec_end_date": Column(
                np.full(
                    n,
                    int((np.datetime64("2002-01-01") - _EPOCH).astype(int)),
                    np.int32,
                ),
                T.DATE,
            ),
            "cc_closed_date_sk": _sk(np.zeros(n)),
            "cc_open_date_sk": _sk(rng.integers(_SALES_LO - 3650, _SALES_LO, n)),
            "cc_name": _ids("call center ", n),
            "cc_class": _pool(rng, n, ("large", "medium", "small")),
            "cc_employees": _int(rng.integers(100, 700, n)),
            "cc_sq_ft": _int(rng.integers(10_000, 50_000, n)),
            "cc_hours": _pool(rng, n, ("8AM-12AM", "8AM-4PM", "8AM-8AM")),
            "cc_manager": _pool(rng, n, _LAST_NAMES),
            "cc_mkt_id": _int(rng.integers(1, 7, n)),
            "cc_mkt_class": _pool(rng, n, ("Unknown",)),
            "cc_mkt_desc": _pool(rng, n, ("Unknown",)),
            "cc_market_manager": _pool(rng, n, _LAST_NAMES),
            "cc_division": _int(rng.integers(1, 7, n)),
            "cc_division_name": _pool(
                rng, n, ("able", "ation", "bar", "ese", "eing", "ought")
            ),
            "cc_company": _int(rng.integers(1, 7, n)),
            "cc_company_name": _pool(
                rng, n, ("able", "ation", "bar", "ese", "eing", "ought")
            ),
            "cc_street_number": _pool(
                rng, n, tuple(str(i) for i in range(1, 1000))
            ),
            "cc_street_name": _pool(rng, n, _STREET_NAMES),
            "cc_street_type": _pool(rng, n, _STREET_TYPES),
            "cc_suite_number": _pool(
                rng, n, tuple(f"Suite {i}" for i in range(100))
            ),
            "cc_city": _pool(rng, n, _CITIES),
            "cc_county": _pool(rng, n, _COUNTIES),
            "cc_state": _pool(rng, n, _STATES[:8]),
            "cc_zip": _pool(rng, n, tuple(f"{z:05d}" for z in range(100, 600))),
            "cc_country": _pool(rng, n, _COUNTRIES),
            "cc_gmt_offset": _dec(rng.choice([-500, -600], n), 2, 5),
            "cc_tax_percentage": _dec(rng.integers(0, 12, n), 2, 5),
        },
    )


def gen_catalog_page(sf: float) -> Table:
    n = _scaled(11_718, sf, lo=100)
    rng = np.random.default_rng(7011)
    return Table(
        "catalog_page",
        {
            "cp_catalog_page_sk": _sk(np.arange(n)),
            "cp_catalog_page_id": _ids("CP", n),
            "cp_start_date_sk": _sk(rng.integers(_SALES_LO, _SALES_HI - 90, n)),
            "cp_end_date_sk": _sk(rng.integers(_SALES_HI - 90, _SALES_HI, n)),
            "cp_department": _pool(rng, n, ("DEPARTMENT",)),
            "cp_catalog_number": _int(rng.integers(1, 110, n)),
            "cp_catalog_page_number": _int(rng.integers(1, 109, n)),
            "cp_description": _ids("catalog page ", n),
            "cp_type": _pool(rng, n, ("bi-annual", "monthly", "quarterly")),
        },
    )


def gen_inventory(sf: float) -> Table:
    # spec: weekly snapshots x items x warehouses
    n = _scaled(11_745_000, sf, lo=5000)
    rng = np.random.default_rng(7012)
    n_item = _scaled(18_000, sf, lo=100)
    n_wh = _scaled(5, sf, lo=3)
    weeks = np.arange(_SALES_LO, _SALES_HI, 7)
    return Table(
        "inventory",
        {
            "inv_date_sk": _sk(rng.choice(weeks, n)),
            "inv_item_sk": _sk(rng.integers(0, n_item, n)),
            "inv_warehouse_sk": _sk(rng.integers(0, n_wh, n)),
            "inv_quantity_on_hand": _int(rng.integers(0, 1000, n)),
        },
    )


# ---------------------------------------------------------------------------
# fact tables: sales + returns (returns reference their sales rows so
# join-back queries like Q25/Q29/Q93 have matching rows)
# ---------------------------------------------------------------------------


def _sales_money(rng, n, qty):
    wholesale = rng.integers(100, 10000, n)
    list_price = (wholesale * rng.uniform(1.2, 2.4, n)).astype(np.int64)
    discount = rng.uniform(0.0, 0.6, n)
    sales_price = (list_price * (1.0 - discount)).astype(np.int64)
    ext_discount = (list_price - sales_price) * qty
    ext_sales = sales_price * qty
    ext_wholesale = wholesale * qty
    ext_list = list_price * qty
    tax = (ext_sales * 0.08).astype(np.int64)
    coupon = (ext_sales * rng.choice([0.0, 0.0, 0.0, 0.1], n)).astype(np.int64)
    net_paid = ext_sales - coupon
    net_paid_tax = net_paid + tax
    profit = net_paid - ext_wholesale
    return {
        "wholesale_cost": wholesale,
        "list_price": list_price,
        "sales_price": sales_price,
        "ext_discount_amt": ext_discount,
        "ext_sales_price": ext_sales,
        "ext_wholesale_cost": ext_wholesale,
        "ext_list_price": ext_list,
        "ext_tax": tax,
        "coupon_amt": coupon,
        "net_paid": net_paid,
        "net_paid_inc_tax": net_paid_tax,
        "net_profit": profit,
    }


def _dims(sf: float):
    return {
        "item": _scaled(18_000, sf, lo=100),
        "customer": _scaled(100_000, sf, lo=500),
        "addr": _scaled(50_000, sf, lo=200),
        "cd": min(1_920_800, _scaled(1_920_800, min(sf, 1.0), lo=2000)),
        "hd": 7200,
        "store": _scaled(12, sf, lo=4),
        "promo": _scaled(300, sf, lo=30),
        "warehouse": _scaled(5, sf, lo=3),
        "web_page": _scaled(60, sf, lo=10),
        "web_site": _scaled(30, sf, lo=5),
        "call_center": _scaled(6, sf, lo=2),
        "catalog_page": _scaled(11_718, sf, lo=100),
        "ship_mode": 20,
        "reason": len(_REASONS),
    }


def gen_store_sales(sf: float) -> Table:
    n = _scaled(2_880_404, sf, lo=2000)
    rng = np.random.default_rng(8001)
    d = _dims(sf)
    qty = rng.integers(1, 101, n)
    m = _sales_money(rng, n, qty)
    # ~2 lines per ticket; ticket shares customer/store/date
    n_tickets = max(n // 2, 1)
    ticket = rng.integers(0, n_tickets, n)
    t_rng = np.random.default_rng(8002)
    t_date = t_rng.integers(_SALES_LO, _SALES_HI, n_tickets)
    t_cust = t_rng.integers(0, d["customer"], n_tickets)
    t_store = t_rng.integers(0, d["store"], n_tickets)
    t_hdemo = t_rng.integers(0, d["hd"], n_tickets)
    t_cdemo = t_rng.integers(0, d["cd"], n_tickets)
    t_addr = t_rng.integers(0, d["addr"], n_tickets)
    return Table(
        "store_sales",
        {
            "ss_sold_date_sk": _sk(t_date[ticket]),
            "ss_sold_time_sk": _sk(rng.integers(28800, 79200, n)),
            "ss_item_sk": _sk(rng.integers(0, d["item"], n)),
            "ss_customer_sk": _sk(t_cust[ticket]),
            "ss_cdemo_sk": _sk(t_cdemo[ticket]),
            "ss_hdemo_sk": _sk(t_hdemo[ticket]),
            "ss_addr_sk": _sk_nullable(t_addr[ticket], rng),
            "ss_store_sk": _sk_nullable(t_store[ticket], rng),
            "ss_promo_sk": _sk(rng.integers(0, d["promo"], n)),
            "ss_ticket_number": _sk(ticket),
            "ss_quantity": _int(qty),
            "ss_wholesale_cost": _dec(m["wholesale_cost"]),
            "ss_list_price": _dec(m["list_price"]),
            "ss_sales_price": _dec(m["sales_price"]),
            "ss_ext_discount_amt": _dec(m["ext_discount_amt"]),
            "ss_ext_sales_price": _dec(m["ext_sales_price"]),
            "ss_ext_wholesale_cost": _dec(m["ext_wholesale_cost"]),
            "ss_ext_list_price": _dec(m["ext_list_price"]),
            "ss_ext_tax": _dec(m["ext_tax"]),
            "ss_coupon_amt": _dec(m["coupon_amt"]),
            "ss_net_paid": _dec(m["net_paid"]),
            "ss_net_paid_inc_tax": _dec(m["net_paid_inc_tax"]),
            "ss_net_profit": _dec(m["net_profit"]),
        },
    )


def gen_store_returns(sf: float) -> Table:
    ss = table("store_sales", sf)
    n_ss = ss.num_rows
    rng = np.random.default_rng(8003)
    n = max(n_ss // 10, 1)
    idx = rng.choice(n_ss, n, replace=False)
    d = _dims(sf)
    qty = np.minimum(
        rng.integers(1, 101, n), ss.columns["ss_quantity"].data[idx]
    )
    sold_date = ss.columns["ss_sold_date_sk"].data[idx]
    amt = (
        ss.columns["ss_sales_price"].data[idx] * qty
    )
    tax = (amt * 0.08).astype(np.int64)
    fee = rng.integers(50, 10000, n)
    ship = rng.integers(100, 5000, n)
    refunded = (amt * rng.uniform(0.3, 1.0, n)).astype(np.int64)
    reversed_ = amt - refunded
    return Table(
        "store_returns",
        {
            "sr_returned_date_sk": _sk(
                np.minimum(sold_date + rng.integers(1, 60, n), _SALES_HI + 59)
            ),
            "sr_return_time_sk": _sk(rng.integers(28800, 79200, n)),
            "sr_item_sk": _sk(ss.columns["ss_item_sk"].data[idx]),
            "sr_customer_sk": _sk(ss.columns["ss_customer_sk"].data[idx]),
            "sr_cdemo_sk": _sk(ss.columns["ss_cdemo_sk"].data[idx]),
            "sr_hdemo_sk": _sk(ss.columns["ss_hdemo_sk"].data[idx]),
            "sr_addr_sk": _sk(
                ss.columns["ss_addr_sk"].data[idx],
                valid=ss.columns["ss_addr_sk"].valid[idx],
            ),
            "sr_store_sk": _sk(
                ss.columns["ss_store_sk"].data[idx],
                valid=ss.columns["ss_store_sk"].valid[idx],
            ),
            "sr_reason_sk": _sk(rng.integers(0, d["reason"], n)),
            "sr_ticket_number": _sk(ss.columns["ss_ticket_number"].data[idx]),
            "sr_return_quantity": _int(qty),
            "sr_return_amt": _dec(amt),
            "sr_return_tax": _dec(tax),
            "sr_return_amt_inc_tax": _dec(amt + tax),
            "sr_fee": _dec(fee),
            "sr_return_ship_cost": _dec(ship),
            "sr_refunded_cash": _dec(refunded),
            "sr_reversed_charge": _dec(reversed_),
            "sr_store_credit": _dec(np.zeros(n)),
            "sr_net_loss": _dec(fee + ship + tax),
        },
    )


def gen_catalog_sales(sf: float) -> Table:
    n = _scaled(1_441_548, sf, lo=1200)
    rng = np.random.default_rng(8004)
    d = _dims(sf)
    qty = rng.integers(1, 101, n)
    m = _sales_money(rng, n, qty)
    n_orders = max(n // 3, 1)
    order = rng.integers(0, n_orders, n)
    o_rng = np.random.default_rng(8005)
    o_date = o_rng.integers(_SALES_LO, _SALES_HI, n_orders)
    o_cust = o_rng.integers(0, d["customer"], n_orders)
    ship_cost = rng.integers(50, 5000, n) * qty
    return Table(
        "catalog_sales",
        {
            "cs_sold_date_sk": _sk(o_date[order]),
            "cs_sold_time_sk": _sk(rng.integers(0, 86400, n)),
            "cs_ship_date_sk": _sk(o_date[order] + rng.integers(2, 90, n)),
            "cs_bill_customer_sk": _sk(o_cust[order]),
            "cs_bill_cdemo_sk": _sk(rng.integers(0, d["cd"], n)),
            "cs_bill_hdemo_sk": _sk(rng.integers(0, d["hd"], n)),
            "cs_bill_addr_sk": _sk(rng.integers(0, d["addr"], n)),
            "cs_ship_customer_sk": _sk(o_cust[order]),
            "cs_ship_cdemo_sk": _sk(rng.integers(0, d["cd"], n)),
            "cs_ship_hdemo_sk": _sk(rng.integers(0, d["hd"], n)),
            "cs_ship_addr_sk": _sk_nullable(rng.integers(0, d["addr"], n), rng),
            "cs_call_center_sk": _sk(rng.integers(0, d["call_center"], n)),
            "cs_catalog_page_sk": _sk(rng.integers(0, d["catalog_page"], n)),
            "cs_ship_mode_sk": _sk(rng.integers(0, d["ship_mode"], n)),
            "cs_warehouse_sk": _sk(rng.integers(0, d["warehouse"], n)),
            "cs_item_sk": _sk(rng.integers(0, d["item"], n)),
            "cs_promo_sk": _sk(rng.integers(0, d["promo"], n)),
            "cs_order_number": _sk(order),
            "cs_quantity": _int(qty),
            "cs_wholesale_cost": _dec(m["wholesale_cost"]),
            "cs_list_price": _dec(m["list_price"]),
            "cs_sales_price": _dec(m["sales_price"]),
            "cs_ext_discount_amt": _dec(m["ext_discount_amt"]),
            "cs_ext_sales_price": _dec(m["ext_sales_price"]),
            "cs_ext_wholesale_cost": _dec(m["ext_wholesale_cost"]),
            "cs_ext_list_price": _dec(m["ext_list_price"]),
            "cs_ext_tax": _dec(m["ext_tax"]),
            "cs_coupon_amt": _dec(m["coupon_amt"]),
            "cs_ext_ship_cost": _dec(ship_cost),
            "cs_net_paid": _dec(m["net_paid"]),
            "cs_net_paid_inc_tax": _dec(m["net_paid_inc_tax"]),
            "cs_net_paid_inc_ship": _dec(m["net_paid"] + ship_cost),
            "cs_net_paid_inc_ship_tax": _dec(
                m["net_paid_inc_tax"] + ship_cost
            ),
            "cs_net_profit": _dec(m["net_profit"]),
        },
    )


def gen_catalog_returns(sf: float) -> Table:
    cs = table("catalog_sales", sf)
    n_cs = cs.num_rows
    rng = np.random.default_rng(8006)
    n = max(n_cs // 10, 1)
    idx = rng.choice(n_cs, n, replace=False)
    d = _dims(sf)
    qty = np.minimum(
        rng.integers(1, 101, n), cs.columns["cs_quantity"].data[idx]
    )
    amt = cs.columns["cs_sales_price"].data[idx] * qty
    tax = (amt * 0.08).astype(np.int64)
    fee = rng.integers(50, 10000, n)
    ship = rng.integers(100, 5000, n)
    refunded = (amt * rng.uniform(0.3, 1.0, n)).astype(np.int64)
    return Table(
        "catalog_returns",
        {
            "cr_returned_date_sk": _sk(
                cs.columns["cs_sold_date_sk"].data[idx]
                + rng.integers(1, 60, n)
            ),
            "cr_returned_time_sk": _sk(rng.integers(0, 86400, n)),
            "cr_item_sk": _sk(cs.columns["cs_item_sk"].data[idx]),
            "cr_refunded_customer_sk": _sk(
                cs.columns["cs_bill_customer_sk"].data[idx]
            ),
            "cr_refunded_cdemo_sk": _sk(rng.integers(0, d["cd"], n)),
            "cr_refunded_hdemo_sk": _sk(rng.integers(0, d["hd"], n)),
            "cr_refunded_addr_sk": _sk(rng.integers(0, d["addr"], n)),
            "cr_returning_customer_sk": _sk(
                cs.columns["cs_bill_customer_sk"].data[idx]
            ),
            "cr_returning_cdemo_sk": _sk(rng.integers(0, d["cd"], n)),
            "cr_returning_hdemo_sk": _sk(rng.integers(0, d["hd"], n)),
            "cr_returning_addr_sk": _sk(rng.integers(0, d["addr"], n)),
            "cr_call_center_sk": _sk(
                cs.columns["cs_call_center_sk"].data[idx]
            ),
            "cr_catalog_page_sk": _sk(
                cs.columns["cs_catalog_page_sk"].data[idx]
            ),
            "cr_ship_mode_sk": _sk(cs.columns["cs_ship_mode_sk"].data[idx]),
            "cr_warehouse_sk": _sk(cs.columns["cs_warehouse_sk"].data[idx]),
            "cr_reason_sk": _sk(rng.integers(0, d["reason"], n)),
            "cr_order_number": _sk(cs.columns["cs_order_number"].data[idx]),
            "cr_return_quantity": _int(qty),
            "cr_return_amount": _dec(amt),
            "cr_return_tax": _dec(tax),
            "cr_return_amt_inc_tax": _dec(amt + tax),
            "cr_fee": _dec(fee),
            "cr_return_ship_cost": _dec(ship),
            "cr_refunded_cash": _dec(refunded),
            "cr_reversed_charge": _dec(amt - refunded),
            "cr_store_credit": _dec(np.zeros(n)),
            "cr_net_loss": _dec(fee + ship + tax),
        },
    )


def gen_web_sales(sf: float) -> Table:
    n = _scaled(719_384, sf, lo=800)
    rng = np.random.default_rng(8007)
    d = _dims(sf)
    qty = rng.integers(1, 101, n)
    m = _sales_money(rng, n, qty)
    # ~4 lines per order, same site+date per order, VARYING warehouse per
    # line (Q95's "orders shipped from more than one warehouse")
    n_orders = max(n // 4, 1)
    order = rng.integers(0, n_orders, n)
    o_rng = np.random.default_rng(8008)
    o_date = o_rng.integers(_SALES_LO, _SALES_HI, n_orders)
    o_cust = o_rng.integers(0, d["customer"], n_orders)
    o_site = o_rng.integers(0, d["web_site"], n_orders)
    o_addr = o_rng.integers(0, d["addr"], n_orders)
    ship_cost = rng.integers(50, 5000, n) * qty
    return Table(
        "web_sales",
        {
            "ws_sold_date_sk": _sk(o_date[order]),
            "ws_sold_time_sk": _sk(rng.integers(0, 86400, n)),
            "ws_ship_date_sk": _sk(o_date[order] + rng.integers(2, 120, n)),
            "ws_item_sk": _sk(rng.integers(0, d["item"], n)),
            "ws_bill_customer_sk": _sk(o_cust[order]),
            "ws_bill_cdemo_sk": _sk(rng.integers(0, d["cd"], n)),
            "ws_bill_hdemo_sk": _sk(rng.integers(0, d["hd"], n)),
            "ws_bill_addr_sk": _sk(rng.integers(0, d["addr"], n)),
            "ws_ship_customer_sk": _sk_nullable(o_cust[order], rng),
            "ws_ship_cdemo_sk": _sk(rng.integers(0, d["cd"], n)),
            "ws_ship_hdemo_sk": _sk(rng.integers(0, d["hd"], n)),
            "ws_ship_addr_sk": _sk(o_addr[order]),
            "ws_web_page_sk": _sk(rng.integers(0, d["web_page"], n)),
            "ws_web_site_sk": _sk(o_site[order]),
            "ws_ship_mode_sk": _sk(rng.integers(0, d["ship_mode"], n)),
            "ws_warehouse_sk": _sk(rng.integers(0, d["warehouse"], n)),
            "ws_promo_sk": _sk(rng.integers(0, d["promo"], n)),
            "ws_order_number": _sk(order),
            "ws_quantity": _int(qty),
            "ws_wholesale_cost": _dec(m["wholesale_cost"]),
            "ws_list_price": _dec(m["list_price"]),
            "ws_sales_price": _dec(m["sales_price"]),
            "ws_ext_discount_amt": _dec(m["ext_discount_amt"]),
            "ws_ext_sales_price": _dec(m["ext_sales_price"]),
            "ws_ext_wholesale_cost": _dec(m["ext_wholesale_cost"]),
            "ws_ext_list_price": _dec(m["ext_list_price"]),
            "ws_ext_tax": _dec(m["ext_tax"]),
            "ws_coupon_amt": _dec(m["coupon_amt"]),
            "ws_ext_ship_cost": _dec(ship_cost),
            "ws_net_paid": _dec(m["net_paid"]),
            "ws_net_paid_inc_tax": _dec(m["net_paid_inc_tax"]),
            "ws_net_paid_inc_ship": _dec(m["net_paid"] + ship_cost),
            "ws_net_paid_inc_ship_tax": _dec(
                m["net_paid_inc_tax"] + ship_cost
            ),
            "ws_net_profit": _dec(m["net_profit"]),
        },
    )


def gen_web_returns(sf: float) -> Table:
    ws = table("web_sales", sf)
    n_ws = ws.num_rows
    rng = np.random.default_rng(8009)
    n = max(n_ws // 10, 1)
    idx = rng.choice(n_ws, n, replace=False)
    d = _dims(sf)
    qty = np.minimum(
        rng.integers(1, 101, n), ws.columns["ws_quantity"].data[idx]
    )
    amt = ws.columns["ws_sales_price"].data[idx] * qty
    tax = (amt * 0.08).astype(np.int64)
    fee = rng.integers(50, 10000, n)
    ship = rng.integers(100, 5000, n)
    refunded = (amt * rng.uniform(0.3, 1.0, n)).astype(np.int64)
    return Table(
        "web_returns",
        {
            "wr_returned_date_sk": _sk(
                ws.columns["ws_sold_date_sk"].data[idx]
                + rng.integers(1, 60, n)
            ),
            "wr_returned_time_sk": _sk(rng.integers(0, 86400, n)),
            "wr_item_sk": _sk(ws.columns["ws_item_sk"].data[idx]),
            "wr_refunded_customer_sk": _sk(
                ws.columns["ws_bill_customer_sk"].data[idx]
            ),
            "wr_refunded_cdemo_sk": _sk(rng.integers(0, d["cd"], n)),
            "wr_refunded_hdemo_sk": _sk(rng.integers(0, d["hd"], n)),
            "wr_refunded_addr_sk": _sk(rng.integers(0, d["addr"], n)),
            "wr_returning_customer_sk": _sk(
                ws.columns["ws_bill_customer_sk"].data[idx]
            ),
            "wr_returning_cdemo_sk": _sk(rng.integers(0, d["cd"], n)),
            "wr_returning_hdemo_sk": _sk(rng.integers(0, d["hd"], n)),
            "wr_returning_addr_sk": _sk(rng.integers(0, d["addr"], n)),
            "wr_web_page_sk": _sk(ws.columns["ws_web_page_sk"].data[idx]),
            "wr_reason_sk": _sk(rng.integers(0, d["reason"], n)),
            "wr_order_number": _sk(ws.columns["ws_order_number"].data[idx]),
            "wr_return_quantity": _int(qty),
            "wr_return_amt": _dec(amt),
            "wr_return_tax": _dec(tax),
            "wr_return_amt_inc_tax": _dec(amt + tax),
            "wr_fee": _dec(fee),
            "wr_return_ship_cost": _dec(ship),
            "wr_refunded_cash": _dec(refunded),
            "wr_reversed_charge": _dec(amt - refunded),
            "wr_account_credit": _dec(np.zeros(n)),
            "wr_net_loss": _dec(fee + ship + tax),
        },
    )


# ---------------------------------------------------------------------------
# module API (mirrors connectors/tpch.py)
# ---------------------------------------------------------------------------

_FIXED = {
    "date_dim": gen_date_dim,
    "time_dim": gen_time_dim,
    "household_demographics": gen_household_demographics,
    "income_band": gen_income_band,
    "ship_mode": gen_ship_mode,
    "reason": gen_reason,
}
_SCALED = {
    "item": gen_item,
    "customer": gen_customer,
    "customer_address": gen_customer_address,
    "customer_demographics": gen_customer_demographics,
    "store": gen_store,
    "warehouse": gen_warehouse,
    "promotion": gen_promotion,
    "web_site": gen_web_site,
    "web_page": gen_web_page,
    "call_center": gen_call_center,
    "catalog_page": gen_catalog_page,
    "inventory": gen_inventory,
    "store_sales": gen_store_sales,
    "store_returns": gen_store_returns,
    "catalog_sales": gen_catalog_sales,
    "catalog_returns": gen_catalog_returns,
    "web_sales": gen_web_sales,
    "web_returns": gen_web_returns,
}

TABLE_NAMES = sorted([*_FIXED, *_SCALED])

_TABLE_CACHE: Dict = {}


def table(name: str, sf: float = 1.0) -> Table:
    # fixed-size dimensions ignore sf — cache them once per process
    key = name if name in _FIXED else (name, sf)
    tb = _TABLE_CACHE.get(key)
    if tb is None:
        if name in _FIXED:
            tb = _FIXED[name]()
        elif name in _SCALED:
            tb = _SCALED[name](sf)
        else:
            raise KeyError(name)
        _TABLE_CACHE[key] = tb
    return tb


def schema(name: str, sf: float = 0.01):
    # schemas are SF-independent; a tiny instance supplies the types
    tb = table(name, min(sf, 0.01))
    return {cname: c.type for cname, c in tb.columns.items()}


_BASE_ROWS = {
    "date_dim": _N_DATES,
    "time_dim": 86_400,
    "household_demographics": 7_200,
    "income_band": 20,
    "ship_mode": 20,
    "reason": len(_REASONS),
    "item": 18_000,
    "customer": 100_000,
    "customer_address": 50_000,
    "customer_demographics": 1_920_800,
    "store": 12,
    "warehouse": 5,
    "promotion": 300,
    "web_site": 30,
    "web_page": 60,
    "call_center": 6,
    "catalog_page": 11_718,
    "inventory": 11_745_000,
    "store_sales": 2_880_404,
    "store_returns": 288_040,
    "catalog_sales": 1_441_548,
    "catalog_returns": 144_154,
    "web_sales": 719_384,
    "web_returns": 71_938,
}

_UNIQUE_COLUMNS = {
    "date_dim": [("d_date_sk",)],
    "time_dim": [("t_time_sk",)],
    "item": [("i_item_sk",)],
    "customer": [("c_customer_sk",)],
    "customer_address": [("ca_address_sk",)],
    "customer_demographics": [("cd_demo_sk",)],
    "household_demographics": [("hd_demo_sk",)],
    "income_band": [("ib_income_band_sk",)],
    "store": [("s_store_sk",)],
    "warehouse": [("w_warehouse_sk",)],
    "promotion": [("p_promo_sk",)],
    "web_site": [("web_site_sk",)],
    "web_page": [("wp_web_page_sk",)],
    "call_center": [("cc_call_center_sk",)],
    "catalog_page": [("cp_catalog_page_sk",)],
    "ship_mode": [("sm_ship_mode_sk",)],
    "reason": [("r_reason_sk",)],
}


class TpcdsCatalog:
    """Catalog + runtime data provider for the embedded TPC-DS connector
    (mirrors TpchCatalog; reference TpcdsMetadata + tpcds/statistics/).
    Implements the planner's Catalog protocol and serves Pages on the
    catalog's device, cached per table."""

    name = "tpcds"

    def __init__(self, sf: float = 1.0, device="cuda"):
        self.sf = sf
        self.device = device
        self._pages: Dict[str, object] = {}
        self._tables: Dict[str, Table] = {}

    def with_device(self, device) -> "TpcdsCatalog":
        """A catalog that serves the same generated host tables (shared, not
        regenerated) as pages on `device`."""
        twin = TpcdsCatalog(self.sf, device=device)
        twin._tables = self._tables
        return twin

    def table_names(self):
        return list(TABLE_NAMES)

    def schema(self, tname: str):
        return schema(tname, self.sf)

    def row_count(self, tname: str) -> int:
        if tname in _FIXED:
            return _BASE_ROWS[tname]
        return max(int(_BASE_ROWS[tname] * self.sf), 1)

    def unique_columns(self, tname: str):
        return _UNIQUE_COLUMNS.get(tname, [])

    def table_version(self, tname: str) -> int:
        """Immutable generated data: constant version, always cacheable."""
        if tname not in TABLE_NAMES:
            raise KeyError(f"table {tname!r} does not exist")
        return 0

    def page(self, tname: str):
        """Full-table Page on the catalog's device, cached per table."""
        pg = self._pages.get(tname)
        if pg is None:
            pg = self.host_table(tname).to_page(device=self.device)
            self._pages[tname] = pg
        return pg

    def host_table(self, tname: str) -> Table:
        """Host-resident (numpy) table, cached per catalog (and shared with
        its `with_device` twins)."""
        tb = self._tables.get(tname)
        if tb is None:
            tb = table(tname, self.sf)
            self._tables[tname] = tb
        return tb

    def exact_row_count(self, tname: str) -> int:
        return self.host_table(tname).num_rows

    def column_stats(self, tname: str, column: str):
        """Exact per-column statistics from the generator's host data
        (reference presto-tpcds tpcds/statistics/), cached."""
        from ..plan.stats import stats_from_column

        cache = getattr(self, "_stats_cache", None)
        if cache is None:
            cache = self._stats_cache = {}
        key = (tname, column)
        if key not in cache:
            col = self.host_table(tname).columns[column]
            cache[key] = stats_from_column(
                col.data,
                getattr(col, "valid", None),
                col.type,
                col.dictionary,
                self.exact_row_count(tname),
            )
        return cache[key]

    def scan(self, tname: str, start: int, stop: int, pad_to=None,
             columns=None, predicate=None):
        """One batch of rows [start, stop) as a Page on the catalog's
        device; honours column pushdown."""
        tb = self.host_table(tname)
        if columns is not None:
            tb = Table(tb.name, {c: tb.columns[c] for c in columns})
        return tb.to_page(start, stop, pad_to=pad_to, device=self.device)
