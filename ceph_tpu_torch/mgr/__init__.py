"""Manager daemon (reference src/mgr/ + src/pybind/mgr/, SURVEY §2.6):
the daemon (manager: perf collection from every up OSD, the HTTP
frontend, the PG autoscaler and balancer reports), its modules
(modules/: alerts, balancer, dashboard, pg_autoscaler, prometheus,
restful, tuner), and the helpers the daemons use: SLO accounting (slo)
and the named health checks (health)."""
