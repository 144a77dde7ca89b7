! Golden-trajectory driver for the reference NoahMP core
! (/root/reference/core/module_noahmp_func.f90).  Compiled by
! build_fortran.sh wherever gfortran exists; the test image has no
! Fortran compiler, so this ships as a dormant, runnable oracle
! (SURVEY.md section 7 step 2; VERDICT round 1 missing #1).
!
! Usage:  golden_driver <config> <forcing.csv>   (run with CWD = tbl dir)
!
! <config>: "key value" lines -- nsteps, dt, veg_tag, soil_tag,
!   opt_veg..opt_stc (12 flags), lat (radians), lutyp, sltyp, slptyp,
!   isc, ist, ice, shdfac, shdmax, tbot, zlvl, plus optional initial
!   state overrides (tg, tv, swc, smc, stc_soil, sneqv, snowh, zwt, wa,
!   lai, sai, canliq, canice).  Unknown keys are fatal.
! <forcing.csv>: one row per step, 15 comma-separated reals:
!   sfctmp,sfcprs,psfc,uu,vv,q2,soldn,lwdn,prcp,cosz,co2air,o2air,
!   foln,julian,yearlen
!
! Output: header line, then one CSV row per step with the prognostic
! state after the step (layout mirrors noahmp_jax.state.State: snow
! slots 1..3 = Fortran -2..0, soil 1..4) and the main fluxes.  This is
! byte-compatible with tests/test_golden_fortran.py's expectations.

program golden_driver
  use noahmp_global, only: nsoil, msnow
  use noahmp_global, only: noahmp_set_options
  use noahmp_func, only: noahmp_sflx
  use noahmp_veg_param, only: noahmp_veg_param_readptable
  use noahmp_soil_param, only: noahmp_soil_param_readptable
  use noahmp_gen_param, only: noahmp_gen_param_readptable
  implicit none

  character(256) :: cfgfile, forfile, key, veg_tag, soil_tag
  character(1024) :: line
  integer :: ios, iu, istep, nsteps, k
  real :: dt

  ! options
  integer :: o_veg, o_crs, o_btr, o_run, o_sfc, o_frz, o_inf
  integer :: o_rad, o_alb, o_snf, o_tbot, o_stc

  ! static
  real :: lat, shdfac, shdmax, tbot, zlvl
  integer :: lutyp, sltyp, slptyp, isc, ist, ice
  real :: zsoil(4)

  ! initial state scalars
  real :: tg0, tv0, swc0, smc0, stcsoil0, sneqv0, snowh0, zwt0, wa0
  real :: lai0, sai0, canliq0, canice0

  ! forcing
  real :: sfctmp, sfcprs, psfc, uu, vv, q2, soldn, lwdn, prcp, cosz
  real :: co2air, o2air, foln, julian
  real :: yearlen_r
  integer :: yearlen

  ! prognostic state (Fortran layer indexing: snow -2..0, soil 1..4)
  real :: albold, sneqvo, tah, eah, fwet, canliq, canice, tv, tg
  real :: qsfc, qsnow, cm, ch, tauss
  integer :: isnow
  real :: stc(-2:4), soilwat(4), smc(4), zsnso(-2:4), snowh, sneqv
  real :: snice(-2:0), snliq(-2:0), ficeold(-2:0)
  real :: zwt, wa, wt, wslake
  real :: lfmass, rtmass, stmass, wood, stblcp, fastcp, lai, sai

  ! outputs
  real :: fsa, fsr, fira, fsh, ssoil, fcev, fgev, fctr, ecan, etran
  real :: edir, trad, tgb, tgv, t2mv, t2mb, q2v, q2b, runsrf, runsub
  real :: apar, psn, sav, sag, fsno, nee, gpp, npp, fveg, albedo
  real :: qsnbot, ponding, ponding1, ponding2, rssun, rssha
  real :: bgap, wgap, chv, chb, emissi, shg, shc, shb, evg, evb
  real :: ghv, ghb, irg, irc, irb, tr, evc, chleaf, chuc, chv2, chb2
  real :: fpice

  ! constants for this offline configuration (match the C++ oracle and
  ! noahmp_jax defaults; dz8w/dx/qc/pblh/iz0tlnd are dormant jref args)
  real, parameter :: dx = 1000.0, dz8w = 20.0, qc = 0.0, pblh = 1000.0
  integer, parameter :: iz0tlnd = 0

  if (command_argument_count() /= 2) then
     write (*, '(A)') 'usage: golden_driver <config> <forcing.csv>'
     stop 2
  end if
  call get_command_argument(1, cfgfile)
  call get_command_argument(2, forfile)

  ! defaults mirror noahmp_jax.state.init_state / init_static
  nsteps = 96; dt = 900.0
  veg_tag = 'USGS'; soil_tag = 'STAS'
  o_veg = 1; o_crs = 1; o_btr = 1; o_run = 1; o_sfc = 1; o_frz = 1
  o_inf = 1; o_rad = 1; o_alb = 2; o_snf = 1; o_tbot = 2; o_stc = 1
  lat = 0.7; lutyp = 7; sltyp = 6; slptyp = 1; isc = 4; ist = 1
  ice = 0; shdfac = 0.7; shdmax = 0.8; tbot = 285.0; zlvl = 10.0
  zsoil = (/ -0.1, -0.4, -1.0, -2.0 /)
  tg0 = 285.0; tv0 = 285.0; swc0 = 0.3; smc0 = 0.3; stcsoil0 = 285.0
  sneqv0 = 0.0; snowh0 = 0.0; zwt0 = 2.5; wa0 = 4900.0
  lai0 = 2.0; sai0 = 0.2; canliq0 = 0.0; canice0 = 0.0

  open (newunit=iu, file=cfgfile, status='old', action='read')
  do
     read (iu, '(A)', iostat=ios) line
     if (ios /= 0) exit
     if (len_trim(line) == 0) cycle
     if (line(1:1) == '#') cycle
     read (line, *) key
     select case (trim(key))
     case ('nsteps'); read (line, *) key, nsteps
     case ('dt'); read (line, *) key, dt
     case ('veg_tag'); read (line, *) key, veg_tag
     case ('soil_tag'); read (line, *) key, soil_tag
     case ('opt_veg'); read (line, *) key, o_veg
     case ('opt_crs'); read (line, *) key, o_crs
     case ('opt_btr'); read (line, *) key, o_btr
     case ('opt_run'); read (line, *) key, o_run
     case ('opt_sfc'); read (line, *) key, o_sfc
     case ('opt_frz'); read (line, *) key, o_frz
     case ('opt_inf'); read (line, *) key, o_inf
     case ('opt_rad'); read (line, *) key, o_rad
     case ('opt_alb'); read (line, *) key, o_alb
     case ('opt_snf'); read (line, *) key, o_snf
     case ('opt_tbot'); read (line, *) key, o_tbot
     case ('opt_stc'); read (line, *) key, o_stc
     case ('lat'); read (line, *) key, lat
     case ('lutyp'); read (line, *) key, lutyp
     case ('sltyp'); read (line, *) key, sltyp
     case ('slptyp'); read (line, *) key, slptyp
     case ('isc'); read (line, *) key, isc
     case ('ist'); read (line, *) key, ist
     case ('ice'); read (line, *) key, ice
     case ('shdfac'); read (line, *) key, shdfac
     case ('shdmax'); read (line, *) key, shdmax
     case ('tbot'); read (line, *) key, tbot
     case ('zlvl'); read (line, *) key, zlvl
     case ('zsoil'); read (line, *) key, zsoil
     case ('tg'); read (line, *) key, tg0
     case ('tv'); read (line, *) key, tv0
     case ('swc'); read (line, *) key, swc0
     case ('smc'); read (line, *) key, smc0
     case ('stc_soil'); read (line, *) key, stcsoil0
     case ('sneqv'); read (line, *) key, sneqv0
     case ('snowh'); read (line, *) key, snowh0
     case ('zwt'); read (line, *) key, zwt0
     case ('wa'); read (line, *) key, wa0
     case ('lai'); read (line, *) key, lai0
     case ('sai'); read (line, *) key, sai0
     case ('canliq'); read (line, *) key, canliq0
     case ('canice'); read (line, *) key, canice0
     case default
        write (*, '(A)') 'FATAL: unknown config key '//trim(key)
        stop 3
     end select
  end do
  close (iu)

  call noahmp_set_options(o_veg, o_crs, o_btr, o_run, o_sfc, o_frz, &
       o_inf, o_rad, o_alb, o_snf, o_tbot, o_stc)
  call noahmp_veg_param_readptable(veg_tag)
  call noahmp_soil_param_readptable(soil_tag)
  call noahmp_gen_param_readptable()

  ! cold-start state (mirrors noahmp_jax.state.init_state)
  canliq = canliq0; canice = canice0; tv = tv0; eah = 1000.0
  tah = tv0; fwet = 0.0; lai = lai0; sai = sai0
  tg = tg0; qsfc = 0.01; cm = 0.01; ch = 0.01
  isnow = 0; snowh = snowh0; sneqv = sneqv0; sneqvo = sneqv0
  snice = 0.0; snliq = 0.0
  zsnso(-2:0) = 0.0
  zsnso(1:4) = zsoil
  albold = 0.65; tauss = 0.0; ficeold = 0.0; qsnow = 0.0
  stc(-2:0) = 273.15
  stc(1:4) = stcsoil0
  soilwat = swc0; smc = smc0
  zwt = zwt0; wa = wa0; wt = wa0; wslake = 0.0
  lfmass = 50.0; rtmass = 500.0; stmass = 50.0
  wood = 500.0; stblcp = 1000.0; fastcp = 1000.0

  write (*, '(A)') 'step,tg,tv,sneqv,snowh,isnow,canliq,canice,eah,'// &
       'tah,cm,ch,zwt,wa,lai,sai,'// &
       'stc1,stc2,stc3,stc4,swc1,swc2,swc3,swc4,smc1,smc2,smc3,smc4,'// &
       'snice1,snice2,snice3,snliq1,snliq2,snliq3,'// &
       'fsa,fsh,fira,fgev,fcev,fctr,ssoil,trad,runsrf,runsub'

  open (newunit=iu, file=forfile, status='old', action='read')
  do istep = 1, nsteps
     read (iu, *, iostat=ios) sfctmp, sfcprs, psfc, uu, vv, q2, &
          soldn, lwdn, prcp, cosz, co2air, o2air, foln, julian, &
          yearlen_r
     if (ios /= 0) then
        write (*, '(A)') 'FATAL: forcing file too short'
        stop 4
     end if
     yearlen = nint(yearlen_r)

     call noahmp_sflx(1, 1, lat, yearlen, julian, cosz, &
          dt, dx, dz8w, nsoil, zsoil, msnow, &
          shdfac, shdmax, slptyp, sltyp, lutyp, ice, ist, &
          isc, &
          iz0tlnd, &
          sfctmp, sfcprs, psfc, uu, vv, q2, &
          qc, soldn, lwdn, prcp, tbot, co2air, &
          o2air, foln, ficeold, pblh, zlvl, &
          albold, sneqvo, &
          stc, soilwat, smc, tah, eah, fwet, &
          canliq, canice, tv, tg, qsfc, qsnow, &
          isnow, zsnso, snowh, sneqv, snice, snliq, &
          zwt, wa, wt, wslake, lfmass, rtmass, &
          stmass, wood, stblcp, fastcp, lai, sai, &
          cm, ch, tauss, &
          fsa, fsr, fira, fsh, ssoil, fcev, &
          fgev, fctr, ecan, etran, edir, trad, &
          tgb, tgv, t2mv, t2mb, q2v, q2b, &
          runsrf, runsub, apar, psn, sav, sag, &
          fsno, nee, gpp, npp, fveg, albedo, &
          qsnbot, ponding, ponding1, ponding2, rssun, rssha, &
          bgap, wgap, chv, chb, emissi, &
          shg, shc, shb, evg, evb, ghv, &
          ghb, irg, irc, irb, tr, evc, &
          chleaf, chuc, chv2, chb2, fpice)

     ! ficeold for the next step (reference driver contract:
     ! ice fraction of each snow layer before the next call)
     do k = -2, 0
        if (snice(k) + snliq(k) > 0.0) then
           ficeold(k) = snice(k) / (snice(k) + snliq(k))
        else
           ficeold(k) = 0.0
        end if
     end do

     write (*, '(I0,43(",",ES16.8))') istep, tg, tv, sneqv, snowh, &
          real(isnow), canliq, canice, eah, tah, cm, ch, zwt, wa, &
          lai, sai, stc(1), stc(2), stc(3), stc(4), &
          soilwat(1), soilwat(2), soilwat(3), soilwat(4), &
          smc(1), smc(2), smc(3), smc(4), &
          snice(-2), snice(-1), snice(0), &
          snliq(-2), snliq(-1), snliq(0), &
          fsa, fsh, fira, fgev, fcev, fctr, ssoil, trad, &
          runsrf, runsub
  end do
  close (iu)
end program golden_driver
