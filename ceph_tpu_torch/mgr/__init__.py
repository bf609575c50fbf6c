"""Manager-side helpers the daemons use: SLO accounting (slo) and the
named health checks (health).  The manager daemon and its modules are
not ported yet."""
