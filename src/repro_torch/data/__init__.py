"""Host-side data plumbing of the port: client sampling, cohorts and
synthetic LM tokens."""
