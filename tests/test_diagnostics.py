"""Chemistry diagnostics: element families, ion charges, species bins.

Reference parity: mass_ch (kpp.f90:5900-6181), ion_mass (str.f90:6503),
bud_* per-reaction budgets (C33).
"""

import numpy as np
import jax.numpy as jnp

from mistra_tpu.chemistry.diagnostics import (element_counts,
                                              family_column_totals,
                                              ion_balance, ion_charge)
from mistra_tpu.chemistry.mech import load_multiphase_mechanism

def test_element_counts_gas_names():
    sp = ["Cl2", "BrCl", "HCl", "CH2I2", "N2O5", "DMS", "SO2", "INO2"]
    assert element_counts(sp, "Cl").tolist() == [2, 1, 1, 0, 0, 0, 0, 0]
    assert element_counts(sp, "I").tolist() == [0, 0, 0, 2, 0, 0, 0, 1]
    assert element_counts(sp, "N").tolist() == [0, 0, 0, 0, 2, 0, 0, 1]
    assert element_counts(sp, "S").tolist() == [0, 0, 0, 0, 0, 1, 1, 0]


def test_element_counts_binned_ions():
    sp = ["Clml1", "Cl2l2", "SO42ml3", "NH4pl1", "Brml4", "HSO4ml1"]
    sb = np.array([1, 2, 3, 1, 4, 1])
    assert element_counts(sp, "Cl", sb).tolist() == [1, 2, 0, 0, 0, 0]
    assert element_counts(sp, "Br", sb).tolist() == [0, 0, 0, 0, 1, 0]
    assert element_counts(sp, "S", sb).tolist() == [0, 0, 1, 0, 0, 1]
    # gas Cl2 must not be mistaken for a bin-2 species
    assert element_counts(["Cl2"], "Cl", np.array([0])).tolist() == [2]


def test_ion_charges():
    assert ion_charge("Clml1") == -1
    assert ion_charge("SO42ml3") == -2
    assert ion_charge("NH4pl2") == 1
    assert ion_charge("Hpl1") == 1
    assert ion_charge("Cl2l1") == 0
    assert ion_charge("Cl2", binned=False) == 0


def test_species_bin_assignment(mechdir):
    tot = load_multiphase_mechanism(mechdir, bins=(1, 2, 3, 4), name="tot")
    n2i = {s: i for i, s in enumerate(tot.species)}
    assert tot.species_bin[n2i["Cl2"]] == 0          # gas, despite "l2"
    assert tot.species_bin[n2i["Cl2l1"]] == 1
    assert tot.species_bin[n2i["Clml2"]] == 2
    assert tot.species_bin[n2i["HNO3l1"]] == 1       # from tot_eqn12.head
    assert tot.nrxn == 1627                          # reference NREACT


def test_family_totals_and_ion_balance():
    sp = ["HCl", "Clml1", "NH4pl1", "SO42ml1"]
    sb = np.array([0, 1, 1, 1])
    conc = jnp.array([[1.0, 2.0], [3.0, 0.0], [5.0, 0.0], [1.0, 0.0]])
    detw = jnp.array([1.0, 2.0])
    tot = family_column_totals(conc, sp, detw, elements=("Cl",),
                               species_bin=sb)
    # HCl: 1*1 + 2*2 = 5; Clml1: 3*1 = 3
    assert float(tot["Cl"]) == 8.0
    bal = ion_balance(conc, sp, sb, nkc=1)
    # level 0: -3 (Clm) + 5 (NH4p) - 2 (SO42m) = 0
    np.testing.assert_allclose(np.asarray(bal[0]), [0.0, 0.0])


def test_species_production_loss():
    from mistra_tpu.chemistry.diagnostics import (species_budget_channels,
                                                  species_production_loss)
    # 2 reactions: R0: A -> B (rate 3), R1: B -> A (rate 1)
    stoich = np.array([[-1.0, 1.0], [1.0, -1.0]])
    rates = jnp.array([3.0, 1.0])
    prod_b, loss_b = species_production_loss(rates, stoich, 1)
    assert float(prod_b) == 3.0 and float(loss_b) == 1.0
    ch = species_budget_channels(rates, stoich, 1)
    assert ch[0] == (0, 3.0) and ch[1] == (1, -1.0)


def test_sulfur_budget_channels(mechdir):
    """S/DMS budget channels (bud_s_{g,a,t}.f generalized): every
    S-moving reaction is a channel; the gas mechanism's DMS oxidation
    chain must be covered."""
    from mistra_tpu.chemistry.diagnostics import sulfur_reaction_channels
    from mistra_tpu.chemistry.mech import load_gas_mechanism
    m = load_gas_mechanism(mechdir)
    idx, labels = sulfur_reaction_channels(m)
    assert len(idx) >= 40          # reference gas file records 13 of 122
    # the named reference channels (bud_s_g.f:71-84) are all S-labelled
    for lab in ("S1", "S2", "S3"):  # SO2+OH, DMS+OH chains
        assert lab in labels
    # no channel without any sulfur species
    import numpy as np
    from mistra_tpu.chemistry.diagnostics import element_counts
    s_cnt = element_counts(m.species, "S")
    st = np.asarray(m.stoich)
    for i in idx:
        assert (np.abs(st[i]) @ (s_cnt > 0)) > 0
