"""The dry run's analysis: the analytic cost model, the H100 roofline, the
meta-device memory tracker and the report (counterpart of
``repro.analysis``)."""
