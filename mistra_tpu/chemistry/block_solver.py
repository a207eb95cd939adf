"""Block-arrow stage solver for the multiphase (aer/tot) mechanisms.

The reference's tot mechanism factorizes a 417-species sparse matrix per
cell with an unrolled pivot-free LU (``KppDecomp_t``
/root/reference/src/tot.f:39468, structure tot_Parameters.h:26-49,
nnz=13,503).  That Doolittle schedule is a long scalar dependency chain
— the worst possible shape for a vector machine.  This module exploits
the *mechanism's own structure* instead: the aqueous bins never couple
to each other chemically (the ×4-cloned master_aqueous.eqn reacts only
within a bin and exchanges with the gas phase,
/root/reference/src/mech/master_aqueous.eqn:225-367), so in the species
order [bin1.., bin2.., bin3.., bin4.., gas..] the Jacobian is
block-arrow:

    [ A11            A1g ]
    [      A22       A2g ]        A_ff: ~80x80 dense per aqueous bin
    [           ..    .. ]        A_fg/A_gf: thin gas-coupling panels
    [ Ag1  Ag2  ..   Agg ]        Agg: ~100x100 gas core

The stage solve becomes dense-block algebra: one batched inverse of all
(cell, bin) diagonal blocks, a batched-matmul Schur complement onto the
gas core, a second inverse there, and matmul/matvec solves.  Every op is a
batched dense contraction or a batched LU inverse (``batched_inv``), with
no gathers, scatters or sequential substitutions in the solve itself.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

_PREC = jax.lax.Precision.HIGHEST


def batched_inv(a: jax.Array) -> jax.Array:
    """inv(A) for a batch of dense matrices [N, m, m] (pivoted LU)."""
    return jnp.linalg.inv(a)


class BlockArrowSolver:
    """Stage-matrix solver  (ghinv*I - J) x = b  for binned mechanisms.

    Implements the rosenbrock.py linop protocol (jac/prepare/solve);
    the Jacobian context is the tuple of dense block arrays directly.
    """

    def __init__(self, mech, dtype=jnp.float32):
        self.mech = mech
        self.dtype = dtype
        blk = np.asarray(mech.species_bin[:mech.nvar])
        bins = sorted(b for b in set(blk.tolist()) if b != 0)
        self.nbin = len(bins)
        self.nvar = mech.nvar
        bin_idx = [np.nonzero(blk == b)[0] for b in bins]
        gas_idx = np.nonzero(blk == 0)[0]
        self.ma = max(len(ix) for ix in bin_idx)     # padded bin width
        self.mg = len(gas_idx)
        nb, ma, mg = self.nbin, self.ma, self.mg

        # species -> (category, row) maps; padded rows stay unmapped
        pos = np.zeros(self.nvar, np.int64)          # row within block
        cat = np.zeros(self.nvar, np.int64)          # 0..nb-1 aq, nb gas
        for f, ix in enumerate(bin_idx):
            pos[ix] = np.arange(len(ix))
            cat[ix] = f
        pos[gas_idx] = np.arange(len(gas_idx))
        cat[gas_idx] = nb

        # padded solution vector layout: [nb*ma aqueous | mg gas]
        vpos = np.where(cat < nb, cat * ma + pos, nb * ma + pos)
        self._vpos = vpos                            # old -> padded slot
        npad = nb * ma + mg
        self.npad = npad
        # gather map padded -> old (padded holes read a trailing zero)
        g2o = np.full(npad, self.nvar, np.int64)
        g2o[vpos] = np.arange(self.nvar)
        self._pad_gather = jnp.asarray(g2o)
        self._out_gather = jnp.asarray(vpos)         # padded -> out order

        # ---- Jacobian term lists per storage category -----------------
        # flat dense storage: [bb | gb | bg | gg] concatenated
        off_bb = 0
        off_gb = nb * ma * ma
        off_bg = off_gb + nb * mg * ma
        off_gg = off_bg + nb * ma * mg
        self.flat_size = off_gg + mg * mg
        self._offs = (off_bb, off_gb, off_bg, off_gg)

        st = np.asarray(mech.stoich)
        ridx = np.asarray(mech.ridx)
        nrxn, nvar = st.shape
        lr_list, coeff_list, tgt_list = [], [], []
        for r in range(nrxn):
            outs = np.nonzero(st[r])[0]
            for l in range(ridx.shape[1]):
                j = int(ridx[r, l])
                if j >= nvar:
                    continue
                cj, pj = int(cat[j]), int(pos[j])
                for i in outs:
                    ci, pi = int(cat[i]), int(pos[i])
                    if ci < nb and cj < nb and ci != cj:
                        raise ValueError(
                            f"cross-bin Jacobian entry {i},{j}")
                    if ci < nb and cj < nb:          # aqueous diag block
                        t = off_bb + (ci * ma + pi) * ma + pj
                    elif ci == nb and cj < nb:       # gas rows, aq cols
                        t = off_gb + (cj * mg + pi) * ma + pj
                    elif ci < nb and cj == nb:       # aq rows, gas cols
                        t = off_bg + (ci * ma + pi) * mg + pj
                    else:                            # gas core
                        t = off_gg + pi * mg + pj
                    lr_list.append(l * nrxn + r)
                    coeff_list.append(float(st[r, i]))
                    tgt_list.append(t)
        order = np.argsort(np.asarray(tgt_list, np.int64), kind="stable")
        self._term_lr = jnp.asarray(np.asarray(lr_list)[order])
        self._term_coeff = jnp.asarray(
            np.asarray(coeff_list)[order], dtype)
        self._term_tgt = jnp.asarray(np.asarray(tgt_list, np.int64)[order])

        # identity masks for adding ghinv on the real (unpadded) diag;
        # padded diagonal entries get plain 1.0 so the block stays
        # invertible and the padded rows remain decoupled
        bbdiag = np.zeros((nb, ma, ma), np.float32)
        bbpad = np.zeros((nb, ma, ma), np.float32)
        for f, ix in enumerate(bin_idx):
            w = len(ix)
            bbdiag[f, :w, :w] = np.eye(w)
            if w < ma:
                bbpad[f, w:, w:] = np.eye(ma - w)
        self._bb_eye = jnp.asarray(bbdiag, dtype)
        self._bb_pad = jnp.asarray(bbpad, dtype)
        self._gg_eye = jnp.asarray(np.eye(mg), dtype)

    # ------------------------------------------------------------------
    def assemble(self, kwcat):
        """Dense block arrays from the per-reaction-slot weights.

        kwcat: [B, 3*nrxn] with kw_l[r] = k_r * prod of the *other*
        reactant concentrations for slot l (gas_kernel.kw_weights).
        Returns (Jbb [B,nb,ma,ma], Jgb [B,nb,mg,ma], Jbg [B,nb,ma,mg],
        Jgg [B,mg,mg]).
        """
        B = kwcat.shape[0]
        vals = self._term_coeff[None, :] * kwcat[:, self._term_lr]
        flat = jnp.zeros((B, self.flat_size), kwcat.dtype)
        flat = flat.at[:, self._term_tgt].add(vals)
        nb, ma, mg = self.nbin, self.ma, self.mg
        o_bb, o_gb, o_bg, o_gg = self._offs
        jbb = flat[:, o_bb:o_gb].reshape(B, nb, ma, ma)
        jgb = flat[:, o_gb:o_bg].reshape(B, nb, mg, ma)
        jbg = flat[:, o_bg:o_gg].reshape(B, nb, ma, mg)
        jgg = flat[:, o_gg:].reshape(B, mg, mg)
        return jbb, jgb, jbg, jgg

    # ---- rosenbrock linop protocol -----------------------------------
    def jac(self, y):
        raise NotImplementedError(
            "bind via gas_kernel.GasKernel (supplies kw weights)")

    @staticmethod
    def _row_scale(m):
        """Power-of-2 reciprocal of a row-magnitude bound (exact in any
        binary float; 1.0 for empty/padded rows)."""
        safe = jnp.where(m > 0.0, m, 1.0)
        return jnp.exp2(-jnp.floor(jnp.log2(safe)))

    def prepare(self, jac_ctx, ghinv):
        """Factorize R*(ghinv*I - J) into (invA, G, H, invS, R).

        R is a per-row power-of-2 equilibration: aqueous equilibrium
        rate constants reach ~1e27 in mol/m3 units (kef/keb,
        kpp.f90:2954-3369), so raw stage-matrix entries hit ~1e18 and
        their elimination products overflow float32 (the reference gets
        away with it only because it is REAL*8 throughout).  Scaling
        rows to O(1) keeps the factorization inside f32 range without
        changing the solution.
        """
        jbb, jgb, jbg, jgg = jac_ctx
        B = jbb.shape[0]
        nb, ma, mg = self.nbin, self.ma, self.mg
        g = ghinv[:, None, None, None]
        abb = (g * self._bb_eye[None] + self._bb_pad[None]) - jbb
        agb = -jgb
        abg = -jbg
        agg = ghinv[:, None, None] * self._gg_eye[None] - jgg

        # row equilibration over the FULL system row (diag + coupling)
        r_aq = self._row_scale(jnp.maximum(
            jnp.max(jnp.abs(abb), axis=-1),
            jnp.max(jnp.abs(abg), axis=-1)))          # [B, nb, ma]
        r_g = self._row_scale(jnp.maximum(
            jnp.max(jnp.abs(agg), axis=-1),
            jnp.max(jnp.abs(agb), axis=(1, 3))))      # [B, mg]
        abb = abb * r_aq[..., None]
        abg = abg * r_aq[..., None]
        agb = agb * r_g[:, None, :, None]
        agg = agg * r_g[..., None]

        inv_a = batched_inv(abb.reshape(B * nb, ma, ma)).reshape(
            B, nb, ma, ma)
        # G_f = Agb_f inv(A_f);  Schur S = Agg - sum_f G_f Abg_f
        gmat = jnp.einsum("bfij,bfjk->bfik", agb, inv_a,
                          precision=_PREC)
        s = agg - jnp.einsum("bfij,bfjk->bik", gmat, abg,
                             precision=_PREC)
        inv_s = batched_inv(s)
        hmat = jnp.einsum("bfij,bfjk->bfik", inv_a, abg,
                          precision=_PREC)
        return (inv_a, gmat, hmat, inv_s, r_aq, r_g,
                abb, agb, abg, agg)

    def _apply_scaled(self, fact, xb, xg):
        """y = A' x for the row-scaled system (block matvecs)."""
        (_, _, _, _, _, _, abb, agb, abg, agg) = fact
        yb = (jnp.einsum("bfij,bfj->bfi", abb, xb, precision=_PREC)
              + jnp.einsum("bfij,bj->bfi", abg, xg, precision=_PREC))
        yg = (jnp.einsum("bij,bj->bi", agg, xg, precision=_PREC)
              + jnp.einsum("bfij,bfj->bi", agb, xb, precision=_PREC))
        return yb, yg

    def _solve_scaled(self, fact, rb, rg):
        inv_a, gmat, hmat, inv_s = fact[:4]
        tb = jnp.einsum("bfij,bfj->bfi", inv_a, rb, precision=_PREC)
        yg = rg - jnp.einsum("bfij,bfj->bi", gmat, rb, precision=_PREC)
        xg = jnp.einsum("bij,bj->bi", inv_s, yg, precision=_PREC)
        xb = tb - jnp.einsum("bfij,bj->bfi", hmat, xg, precision=_PREC)
        return xb, xg

    def solve(self, fact, rhs, refine: int = 1):
        """x = (ghinv*I - J)^{-1} rhs via the block factorization.

        One pass of iterative refinement by default: the explicit
        block inverses leave O(cond*eps) residuals which can cost the
        stiff integrator extra step rejections; a single correction
        reduces them by several orders of magnitude.
        """
        r_aq, r_g = fact[4], fact[5]
        B = rhs.shape[0]
        nb, ma, mg = self.nbin, self.ma, self.mg
        rhs_z = jnp.concatenate(
            [rhs, jnp.zeros((B, 1), rhs.dtype)], axis=-1)
        rp = rhs_z[:, self._pad_gather]
        rb = rp[:, :nb * ma].reshape(B, nb, ma) * r_aq
        rg = rp[:, nb * ma:] * r_g
        xb, xg = self._solve_scaled(fact, rb, rg)
        for _ in range(refine):
            ab, ag = self._apply_scaled(fact, xb, xg)
            db, dg = self._solve_scaled(fact, rb - ab, rg - ag)
            xb = xb + db
            xg = xg + dg
        xp = jnp.concatenate([xb.reshape(B, nb * ma), xg], axis=-1)
        return xp[:, self._out_gather]
