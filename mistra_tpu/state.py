"""Model state as a single JAX pytree.

The reference scatters state over ~60 COMMON blocks; here everything
prognostic or time-varying lives in one nested pytree of frozen
dataclasses (``utils.pytree.pytree_dataclass``) so the whole model step is
a pure function ``step(state, consts) -> state`` that jits, vmaps (column
ensembles), shards and checkpoints trivially.

Shapes are per-column (no batch axis); ensembles add a leading axis via
``jax.vmap`` / ``shard_map`` (see mistra_tpu.parallel).
"""

from __future__ import annotations

import jax.numpy as jnp
from .utils.pytree import pytree_dataclass

from .config import MistraConfig
from .grids import Grids


@pytree_dataclass
class MetState:
    """Meteorological column state (reference cb42/cb45/cb53/cb54)."""
    u: jnp.ndarray        # [n] horizontal wind x [m/s]
    v: jnp.ndarray        # [n] horizontal wind y [m/s]
    w: jnp.ndarray        # [n] prescribed subsidence [m/s] (static profile)
    t: jnp.ndarray        # [n] temperature [K]
    theta: jnp.ndarray    # [n] potential temperature [K]
    thetl: jnp.ndarray    # [n] liquid water potential temperature [K]
    talt: jnp.ndarray     # [n] temperature at previous radiation call [K]
    p: jnp.ndarray        # [n] hydrostatic pressure [Pa] (static profile)
    rho: jnp.ndarray      # [n] air density [kg/m3]
    xm1: jnp.ndarray      # [n] specific humidity [kg/kg]
    xm1a: jnp.ndarray     # [n] specific humidity before last diffusion step
    xm2: jnp.ndarray      # [n] liquid water content [kg/m3]
    feu: jnp.ndarray      # [n] relative humidity [1]
    dfddt: jnp.ndarray    # [n] temperature tendency from condensation [K/s]
    tke: jnp.ndarray      # [n] turbulent kinetic energy [m2/s2]
    tkep: jnp.ndarray     # [n] TKE production rate [m2/s3]
    buoy: jnp.ndarray     # [n] buoyancy gradient term (filtered)


@pytree_dataclass
class TurbState:
    """Turbulence closure state (reference cb42/cb43)."""
    atke: jnp.ndarray     # [n] exchange coefficient for TKE [m2/s]
    atkh: jnp.ndarray     # [n] exchange coefficient for heat [m2/s]
    atkm: jnp.ndarray     # [n] exchange coefficient for momentum [m2/s]
    gm: jnp.ndarray       # [n] shear stability argument
    gh: jnp.ndarray       # [n] buoyancy stability argument
    sm: jnp.ndarray       # [n] stability function Sm (filtered state)
    sh: jnp.ndarray       # [n] stability function Sh (filtered state)
    xl: jnp.ndarray       # [n] mixing length [m]
    tkeps: jnp.ndarray    # [n] TKE shear production (diagnostic)
    tkepb: jnp.ndarray    # [n] TKE buoyant production (diagnostic)
    tkepd: jnp.ndarray    # [n] TKE dissipation (diagnostic)


@pytree_dataclass
class SurfaceState:
    """Surface / Prandtl layer state (reference data_surface + cb47)."""
    tw: jnp.ndarray       # water surface temperature [K]
    ustern: jnp.ndarray   # frictional velocity [m/s]
    z0: jnp.ndarray       # roughness length [m]
    gclu: jnp.ndarray     # Clarke function, momentum
    gclt: jnp.ndarray     # Clarke function, heat/moisture
    tb: jnp.ndarray       # [nb] soil temperature [K]
    eb: jnp.ndarray       # [nb] soil volumetric moisture [m3/m3]
    # surface flux / deposit accumulators (cb47)
    ajs: jnp.ndarray      # droplet sedimentation water flux [kg/m2/s]
    ds1: jnp.ndarray      # deposited aerosol mass
    ds2: jnp.ndarray      # deposited water mass
    trdep: jnp.ndarray    # total deposited particles
    tau: jnp.ndarray      # dew reservoir [kg/m2]
    reif: jnp.ndarray     # rime reservoir [kg/m2]
    ajb: jnp.ndarray      # soil heat flux
    ajq: jnp.ndarray      # surface moisture flux
    ajl: jnp.ndarray      # latent enthalpy flux
    ajt: jnp.ndarray      # sensible enthalpy flux
    ajm: jnp.ndarray      # ground moisture flux
    ajd: jnp.ndarray      # dew flux


@pytree_dataclass
class MicroState:
    """2-D spectral bin microphysics state (reference cb52)."""
    ff: jnp.ndarray       # [nkt, nka, n] particle number density [1/cm3]
    fsum: jnp.ndarray     # [n] total particle number [1/cm3]
    lcl: jnp.ndarray      # cloud base layer index (0-based, int32)
    lct: jnp.ndarray      # cloud top layer index (0-based, int32)
    vd: jnp.ndarray       # [nkt, nka] particle dry deposition velocity [m/s]
    xra: jnp.ndarray      # aerodynamic resistance [s/m]


@pytree_dataclass
class RadState:
    """Radiation outputs carried between the 60-s radiation calls."""
    dtrad: jnp.ndarray    # [n] radiative heating rate [K/s]
    totrad: jnp.ndarray   # [mb, n] band-integrated actinic term for growth
    u0: jnp.ndarray       # cosine of solar zenith angle
    sk: jnp.ndarray       # net solar radiation flux at the surface [W/m2]
    sl: jnp.ndarray       # downward longwave flux at the surface [W/m2]


@pytree_dataclass
class TimeState:
    time: jnp.ndarray     # model time [s]
    lday: jnp.ndarray     # local day counter (int32)
    lst: jnp.ndarray      # local hour (int32)
    lmin: jnp.ndarray     # local minute (int32)
    kinv: jnp.ndarray     # inversion layer index (0-based, int32)


@pytree_dataclass
class ModelState:
    met: MetState
    turb: TurbState
    surf: SurfaceState
    micro: MicroState
    rad: RadState
    tim: TimeState
    # chemistry state is attached in mistra_tpu.chemistry when chem=True
    chem: object = None


def zeros_state(cfg: MistraConfig, grids: Grids) -> ModelState:
    """Allocate an all-zero state with the right shapes/dtypes."""
    gp = cfg.grid
    dt = jnp.float64 if cfg.dtype == "float64" else jnp.float32
    n, nb, nka, nkt, mb = gp.n, gp.nb, gp.nka, gp.nkt, gp.mb

    def z(*shape):
        return jnp.zeros(shape, dtype=dt)

    def zi():
        return jnp.zeros((), dtype=jnp.int32)

    return ModelState(
        met=MetState(u=z(n), v=z(n), w=z(n), t=z(n), theta=z(n), thetl=z(n),
                     talt=z(n), p=z(n), rho=z(n), xm1=z(n), xm1a=z(n),
                     xm2=z(n), feu=z(n), dfddt=z(n), tke=z(n), tkep=z(n),
                     buoy=z(n)),
        turb=TurbState(atke=z(n), atkh=z(n), atkm=z(n), gm=z(n), gh=z(n),
                       sm=z(n), sh=z(n), xl=z(n), tkeps=z(n), tkepb=z(n),
                       tkepd=z(n)),
        surf=SurfaceState(tw=z(), ustern=z(), z0=z(), gclu=z(), gclt=z(),
                          tb=z(nb), eb=z(nb), ajs=z(), ds1=z(), ds2=z(),
                          trdep=z(), tau=z(), reif=z(), ajb=z(), ajq=z(),
                          ajl=z(), ajt=z(), ajm=z(), ajd=z()),
        micro=MicroState(ff=z(nkt, nka, n), fsum=z(n), lcl=zi(), lct=zi(),
                         vd=z(nkt, nka), xra=z()),
        rad=RadState(dtrad=z(n), totrad=z(mb, n), u0=z(), sk=z(), sl=z()),
        tim=TimeState(time=z(), lday=zi(), lst=zi(), lmin=zi(), kinv=zi()),
    )
