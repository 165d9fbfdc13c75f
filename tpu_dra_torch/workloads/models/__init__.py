"""Model configurations and parameter trees."""
