"""Host-side data plumbing of the port: client sampling and cohorts."""
