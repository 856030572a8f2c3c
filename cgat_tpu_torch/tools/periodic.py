"""Minimal periodic-table data (symbol -> atomic number); counterpart of
``cgat_tpu/tools/periodic.py``.

Replaces the reference's pymatgen ``Element(...).Z`` lookups
(reference Utilities/sample.py:100) without the pymatgen dependency.
"""

_SYMBOLS = (
    "H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe Co "
    "Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In Sn Sb "
    "Te I Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf Ta W Re "
    "Os Ir Pt Au Hg Tl Pb Bi Po At Rn Fr Ra Ac Th Pa U Np Pu Am Cm Bk Cf Es "
    "Fm Md No Lr Rf Db Sg Bh Hs Mt Ds Rg Cn Nh Fl Mc Lv Ts Og"
).split()

SYMBOL_TO_Z = {s: i + 1 for i, s in enumerate(_SYMBOLS)}
Z_TO_SYMBOL = {z: s for s, z in SYMBOL_TO_Z.items()}
MAX_Z = len(_SYMBOLS)


def symbol_to_z(symbol: str) -> int:
    return SYMBOL_TO_Z[symbol.rstrip("0123456789")]
