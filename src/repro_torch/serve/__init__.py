"""Single-tenant serving engine and sampling."""
