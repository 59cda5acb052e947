"""Optional plotly viewers (plotly is imported when a figure is made)."""
