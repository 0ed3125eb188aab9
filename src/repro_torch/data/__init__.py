"""Host-side data plumbing of the port: client sampling, the
fault-injecting cohort source, cohorts, synthetic least squares and
synthetic LM tokens."""
