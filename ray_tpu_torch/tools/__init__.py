"""Developer tools of the port: the graftlint static checker."""
