"""TPC-DS queries 76-99 as SQL text.

Copied from ``spark_rapids_tpu/tpcds/q76_99.py``.
"""

Q = {}

Q[76] = """
select channel, col_name, d_year, d_qoy, i_category, count(*) sales_cnt,
       sum(ext_sales_price) sales_amt
from (select 'store' as channel, 'ss_store_sk' col_name, d_year, d_qoy,
             i_category, ss_ext_sales_price ext_sales_price
      from store_sales, item, date_dim
      where ss_store_sk is null and ss_sold_date_sk = d_date_sk
        and ss_item_sk = i_item_sk
      union all
      select 'web' as channel, 'ws_promo_sk' col_name, d_year, d_qoy,
             i_category, ws_ext_sales_price ext_sales_price
      from web_sales, item, date_dim
      where ws_promo_sk is null and ws_sold_date_sk = d_date_sk
        and ws_item_sk = i_item_sk
      union all
      select 'catalog' as channel, 'cs_promo_sk' col_name, d_year, d_qoy,
             i_category, cs_ext_sales_price ext_sales_price
      from catalog_sales, item, date_dim
      where cs_promo_sk is null and cs_sold_date_sk = d_date_sk
        and cs_item_sk = i_item_sk) foo
group by channel, col_name, d_year, d_qoy, i_category
order by channel, col_name, d_year, d_qoy, i_category
limit 100
"""

Q[77] = """
with ss as (
  select s_store_sk, sum(ss_ext_sales_price) as sales,
         sum(ss_net_profit) as profit
  from store_sales, date_dim, store
  where ss_sold_date_sk = d_date_sk
    and d_date between date '2000-08-23'
                   and date '2000-08-23' + interval '30' day
    and ss_store_sk = s_store_sk
  group by s_store_sk),
 sr as (
  select s_store_sk, sum(sr_return_amt) as returns_,
         sum(sr_net_loss) as profit_loss
  from store_returns, date_dim, store
  where sr_returned_date_sk = d_date_sk
    and d_date between date '2000-08-23'
                   and date '2000-08-23' + interval '30' day
    and sr_store_sk = s_store_sk
  group by s_store_sk),
 cs as (
  select cs_call_center_sk, sum(cs_ext_sales_price) as sales,
         sum(cs_net_profit) as profit
  from catalog_sales, date_dim
  where cs_sold_date_sk = d_date_sk
    and d_date between date '2000-08-23'
                   and date '2000-08-23' + interval '30' day
  group by cs_call_center_sk),
 cr as (
  select cr_call_center_sk, sum(cr_return_amount) as returns_,
         sum(cr_net_loss) as profit_loss
  from catalog_returns, date_dim
  where cr_returned_date_sk = d_date_sk
    and d_date between date '2000-08-23'
                   and date '2000-08-23' + interval '30' day
  group by cr_call_center_sk),
 ws as (
  select wp_web_page_sk, sum(ws_ext_sales_price) as sales,
         sum(ws_net_profit) as profit
  from web_sales, date_dim, web_page
  where ws_sold_date_sk = d_date_sk
    and d_date between date '2000-08-23'
                   and date '2000-08-23' + interval '30' day
    and ws_web_page_sk = wp_web_page_sk
  group by wp_web_page_sk),
 wr as (
  select wp_web_page_sk, sum(wr_return_amt) as returns_,
         sum(wr_net_loss) as profit_loss
  from web_returns, date_dim, web_page
  where wr_returned_date_sk = d_date_sk
    and d_date between date '2000-08-23'
                   and date '2000-08-23' + interval '30' day
    and wr_web_page_sk = wp_web_page_sk
  group by wp_web_page_sk)
select channel, id, sum(sales) as sales, sum(returns_) as returns_,
       sum(profit) as profit
from (select 'store channel' as channel, ss.s_store_sk as id, sales,
             coalesce(returns_, 0) returns_,
             (profit - coalesce(profit_loss, 0)) as profit
      from ss left join sr on ss.s_store_sk = sr.s_store_sk
      union all
      select 'catalog channel' as channel, cs_call_center_sk as id, sales,
             returns_, (profit - profit_loss) as profit
      from cs, cr
      union all
      select 'web channel' as channel, ws.wp_web_page_sk as id, sales,
             coalesce(returns_, 0) returns_,
             (profit - coalesce(profit_loss, 0)) as profit
      from ws left join wr on ws.wp_web_page_sk = wr.wp_web_page_sk
     ) x
group by rollup (channel, id)
order by channel nulls last, id nulls last, sales
limit 100
"""

Q[78] = """
with ws as (
  select d_year as ws_sold_year, ws_item_sk,
         ws_bill_customer_sk ws_customer_sk, sum(ws_quantity) ws_qty,
         sum(ws_wholesale_cost) ws_wc, sum(ws_sales_price) ws_sp
  from web_sales
       left join web_returns on wr_order_number = ws_order_number
                            and ws_item_sk = wr_item_sk,
       date_dim
  where wr_order_number is null and ws_sold_date_sk = d_date_sk
  group by d_year, ws_item_sk, ws_bill_customer_sk),
 cs as (
  select d_year as cs_sold_year, cs_item_sk,
         cs_bill_customer_sk cs_customer_sk, sum(cs_quantity) cs_qty,
         sum(cs_wholesale_cost) cs_wc, sum(cs_sales_price) cs_sp
  from catalog_sales
       left join catalog_returns on cr_order_number = cs_order_number
                                and cs_item_sk = cr_item_sk,
       date_dim
  where cr_order_number is null and cs_sold_date_sk = d_date_sk
  group by d_year, cs_item_sk, cs_bill_customer_sk),
 ss as (
  select d_year as ss_sold_year, ss_item_sk,
         ss_customer_sk, sum(ss_quantity) ss_qty,
         sum(ss_wholesale_cost) ss_wc, sum(ss_sales_price) ss_sp
  from store_sales
       left join store_returns on sr_ticket_number = ss_ticket_number
                              and ss_item_sk = sr_item_sk,
       date_dim
  where sr_ticket_number is null and ss_sold_date_sk = d_date_sk
  group by d_year, ss_item_sk, ss_customer_sk)
select ss_sold_year, ss_item_sk, ss_customer_sk,
       round(cast(ss_qty as double)
             / (coalesce(ws_qty, 0) + coalesce(cs_qty, 0) + 1), 2) ratio,
       ss_qty store_qty, ss_wc store_wholesale_cost,
       ss_sp store_sales_price,
       coalesce(ws_qty, 0) + coalesce(cs_qty, 0) other_chan_qty,
       coalesce(ws_wc, 0) + coalesce(cs_wc, 0) other_chan_wholesale_cost,
       coalesce(ws_sp, 0) + coalesce(cs_sp, 0) other_chan_sales_price
from ss
     left join ws on (ws_sold_year = ss_sold_year
                      and ws_item_sk = ss_item_sk
                      and ws_customer_sk = ss_customer_sk)
     left join cs on (cs_sold_year = ss_sold_year
                      and cs_item_sk = ss_item_sk
                      and cs_customer_sk = ss_customer_sk)
where (coalesce(ws_qty, 0) > 0 or coalesce(cs_qty, 0) > 0)
  and ss_sold_year = 2000
order by ss_sold_year, ss_item_sk, ss_customer_sk, store_qty desc,
         store_wholesale_cost desc, store_sales_price desc, other_chan_qty,
         other_chan_wholesale_cost, other_chan_sales_price, ratio
limit 100
"""

Q[79] = """
select c_last_name, c_first_name, substr(s_city, 1, 30), ss_ticket_number,
       amt, profit
from (select ss_ticket_number, ss_customer_sk, store.s_city,
             sum(ss_coupon_amt) amt, sum(ss_net_profit) profit
      from store_sales, date_dim, store, household_demographics
      where ss_sold_date_sk = d_date_sk and ss_store_sk = s_store_sk
        and ss_hdemo_sk = hd_demo_sk
        and (hd_dep_count = 6 or hd_vehicle_count > 2)
        and d_dow = 1 and d_year in (1999, 2000, 2001)
        and s_number_employees between 200 and 295
      group by ss_ticket_number, ss_customer_sk, ss_addr_sk,
               store.s_city) ms,
     customer
where ss_customer_sk = c_customer_sk
order by c_last_name, c_first_name, substr(s_city, 1, 30), profit
limit 100
"""

Q[80] = """
with ssr as (
  select s_store_id as store_id, sum(ss_ext_sales_price) as sales,
         sum(coalesce(sr_return_amt, 0)) as returns_,
         sum(ss_net_profit - coalesce(sr_net_loss, 0)) as profit
  from store_sales
       left outer join store_returns
         on (ss_item_sk = sr_item_sk and ss_ticket_number = sr_ticket_number),
       date_dim, store, item, promotion
  where ss_sold_date_sk = d_date_sk
    and d_date between date '2000-08-23'
                   and date '2000-08-23' + interval '30' day
    and ss_store_sk = s_store_sk and ss_item_sk = i_item_sk
    and i_current_price > 50 and ss_promo_sk = p_promo_sk
    and p_channel_tv = 'N'
  group by s_store_id),
 csr as (
  select cp_catalog_page_id as catalog_page_id,
         sum(cs_ext_sales_price) as sales,
         sum(coalesce(cr_return_amount, 0)) as returns_,
         sum(cs_net_profit - coalesce(cr_net_loss, 0)) as profit
  from catalog_sales
       left outer join catalog_returns
         on (cs_item_sk = cr_item_sk and cs_order_number = cr_order_number),
       date_dim, catalog_page, item, promotion
  where cs_sold_date_sk = d_date_sk
    and d_date between date '2000-08-23'
                   and date '2000-08-23' + interval '30' day
    and cs_catalog_page_sk = cp_catalog_page_sk and cs_item_sk = i_item_sk
    and i_current_price > 50 and cs_promo_sk = p_promo_sk
    and p_channel_tv = 'N'
  group by cp_catalog_page_id),
 wsr as (
  select web_site_id, sum(ws_ext_sales_price) as sales,
         sum(coalesce(wr_return_amt, 0)) as returns_,
         sum(ws_net_profit - coalesce(wr_net_loss, 0)) as profit
  from web_sales
       left outer join web_returns
         on (ws_item_sk = wr_item_sk and ws_order_number = wr_order_number),
       date_dim, web_site, item, promotion
  where ws_sold_date_sk = d_date_sk
    and d_date between date '2000-08-23'
                   and date '2000-08-23' + interval '30' day
    and ws_web_site_sk = web_site_sk and ws_item_sk = i_item_sk
    and i_current_price > 50 and ws_promo_sk = p_promo_sk
    and p_channel_tv = 'N'
  group by web_site_id)
select channel, id, sum(sales) as sales, sum(returns_) as returns_,
       sum(profit) as profit
from (select 'store channel' as channel, 'store' || store_id as id,
             sales, returns_, profit
      from ssr
      union all
      select 'catalog channel' as channel,
             'catalog_page' || catalog_page_id as id, sales, returns_,
             profit
      from csr
      union all
      select 'web channel' as channel, 'web_site' || web_site_id as id,
             sales, returns_, profit
      from wsr) x
group by rollup (channel, id)
order by channel nulls last, id nulls last, sales
limit 100
"""

Q[81] = """
with customer_total_return as (
  select cr_returning_customer_sk as ctr_customer_sk, ca_state as ctr_state,
         sum(cr_return_amt_inc_tax) as ctr_total_return
  from catalog_returns, date_dim, customer_address
  where cr_returned_date_sk = d_date_sk and d_year = 2000
    and cr_returning_addr_sk = ca_address_sk
  group by cr_returning_customer_sk, ca_state)
select c_customer_id, c_salutation, c_first_name, c_last_name,
       ca_street_number, ca_street_name, ca_street_type, ca_suite_number,
       ca_city, ca_county, ca_state, ca_zip, ca_country, ca_gmt_offset,
       ca_location_type, ctr_total_return
from customer_total_return ctr1, customer_address, customer
where ctr1.ctr_total_return > (select avg(ctr_total_return) * 1.2
                               from customer_total_return ctr2
                               where ctr1.ctr_state = ctr2.ctr_state)
  and ca_address_sk = c_current_addr_sk and ca_state = 'GA'
  and ctr1.ctr_customer_sk = c_customer_sk
order by c_customer_id, c_salutation, c_first_name, c_last_name,
         ca_street_number, ca_street_name, ca_street_type, ca_suite_number,
         ca_city, ca_county, ca_state, ca_zip, ca_country, ca_gmt_offset,
         ca_location_type, ctr_total_return
limit 100
"""

Q[82] = """
select i_item_id, i_item_desc, i_current_price
from item, inventory, date_dim, store_sales
where i_current_price between 62 and 62 + 30 and inv_item_sk = i_item_sk
  and d_date_sk = inv_date_sk
  and d_date between date '2000-05-25' and date '2000-05-25' + interval '60' day
  and i_manufact_id in (129, 270, 821, 423)
  and inv_quantity_on_hand between 100 and 500 and ss_item_sk = i_item_sk
group by i_item_id, i_item_desc, i_current_price
order by i_item_id
limit 100
"""

Q[83] = """
with sr_items as (
  select i_item_id item_id, sum(sr_return_quantity) sr_item_qty
  from store_returns, item, date_dim
  where sr_item_sk = i_item_sk
    and d_date in (select d_date from date_dim
                   where d_week_seq in (select d_week_seq from date_dim
                                        where d_date in (date '2000-06-30',
                                                         date '2000-09-27',
                                                         date '2000-11-17')))
    and sr_returned_date_sk = d_date_sk
  group by i_item_id),
 cr_items as (
  select i_item_id item_id, sum(cr_return_quantity) cr_item_qty
  from catalog_returns, item, date_dim
  where cr_item_sk = i_item_sk
    and d_date in (select d_date from date_dim
                   where d_week_seq in (select d_week_seq from date_dim
                                        where d_date in (date '2000-06-30',
                                                         date '2000-09-27',
                                                         date '2000-11-17')))
    and cr_returned_date_sk = d_date_sk
  group by i_item_id),
 wr_items as (
  select i_item_id item_id, sum(wr_return_quantity) wr_item_qty
  from web_returns, item, date_dim
  where wr_item_sk = i_item_sk
    and d_date in (select d_date from date_dim
                   where d_week_seq in (select d_week_seq from date_dim
                                        where d_date in (date '2000-06-30',
                                                         date '2000-09-27',
                                                         date '2000-11-17')))
    and wr_returned_date_sk = d_date_sk
  group by i_item_id)
select sr_items.item_id,
       sr_item_qty,
       cast(sr_item_qty as double)
         / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 * 100 sr_dev,
       cr_item_qty,
       cast(cr_item_qty as double)
         / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 * 100 cr_dev,
       wr_item_qty,
       cast(wr_item_qty as double)
         / (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 * 100 wr_dev,
       (sr_item_qty + cr_item_qty + wr_item_qty) / 3.0 average
from sr_items, cr_items, wr_items
where sr_items.item_id = cr_items.item_id
  and sr_items.item_id = wr_items.item_id
order by sr_items.item_id, sr_item_qty
limit 100
"""

Q[84] = """
select c_customer_id as customer_id,
       coalesce(c_last_name, '') || ', ' || coalesce(c_first_name, '')
         as customername
from customer, customer_address, customer_demographics,
     household_demographics, income_band, store_returns
where ca_city = 'Fairview' and c_current_addr_sk = ca_address_sk
  and ib_lower_bound >= 30000 and ib_upper_bound <= 30000 + 50000
  and ib_income_band_sk = hd_income_band_sk
  and cd_demo_sk = c_current_cdemo_sk
  and hd_demo_sk = c_current_hdemo_sk
  and sr_cdemo_sk = cd_demo_sk
order by c_customer_id
limit 100
"""

Q[85] = """
select substr(r_reason_desc, 1, 20), avg(ws_quantity), avg(wr_refunded_cash),
       avg(wr_fee)
from web_sales, web_returns, web_page, customer_demographics cd1,
     customer_demographics cd2, customer_address, date_dim, reason
where ws_web_page_sk = wp_web_page_sk and ws_item_sk = wr_item_sk
  and ws_order_number = wr_order_number
  and ws_sold_date_sk = d_date_sk and d_year = 2000
  and cd1.cd_demo_sk = wr_refunded_cdemo_sk
  and cd2.cd_demo_sk = wr_returning_cdemo_sk
  and ca_address_sk = wr_refunded_addr_sk and r_reason_sk = wr_reason_sk
  and ((cd1.cd_marital_status = 'M'
        and cd1.cd_marital_status = cd2.cd_marital_status
        and cd1.cd_education_status = 'Advanced Degree'
        and cd1.cd_education_status = cd2.cd_education_status
        and ws_sales_price between 100.00 and 150.00)
    or (cd1.cd_marital_status = 'S'
        and cd1.cd_marital_status = cd2.cd_marital_status
        and cd1.cd_education_status = 'College'
        and cd1.cd_education_status = cd2.cd_education_status
        and ws_sales_price between 50.00 and 100.00)
    or (cd1.cd_marital_status = 'W'
        and cd1.cd_marital_status = cd2.cd_marital_status
        and cd1.cd_education_status = '2 yr Degree'
        and cd1.cd_education_status = cd2.cd_education_status
        and ws_sales_price between 150.00 and 200.00))
  and ((ca_country = 'United States' and ca_state in ('IN', 'OH', 'NJ')
        and ws_net_profit between 100 and 200)
    or (ca_country = 'United States' and ca_state in ('WI', 'CT', 'KY')
        and ws_net_profit between 150 and 300)
    or (ca_country = 'United States' and ca_state in ('LA', 'IA', 'AR')
        and ws_net_profit between 50 and 250))
group by r_reason_desc
order by substr(r_reason_desc, 1, 20), avg(ws_quantity),
         avg(wr_refunded_cash), avg(wr_fee)
limit 100
"""

Q[86] = """
select sum(ws_net_paid) as total_sum, i_category, i_class,
       grouping(i_category) + grouping(i_class) as lochierarchy,
       rank() over (partition by grouping(i_category) + grouping(i_class),
                    case when grouping(i_class) = 0 then i_category end
                    order by sum(ws_net_paid) desc) as rank_within_parent
from web_sales, date_dim d1, item
where d1.d_month_seq between 360 and 360 + 11
  and d1.d_date_sk = ws_sold_date_sk and i_item_sk = ws_item_sk
group by rollup (i_category, i_class)
order by lochierarchy desc, case when lochierarchy = 0 then i_category end,
         rank_within_parent
limit 100
"""

Q[87] = """
select count(*)
from ((select distinct c_last_name, c_first_name, d_date
       from store_sales, date_dim, customer
       where store_sales.ss_sold_date_sk = date_dim.d_date_sk
         and store_sales.ss_customer_sk = customer.c_customer_sk
         and d_month_seq between 360 and 360 + 11)
      except
      (select distinct c_last_name, c_first_name, d_date
       from catalog_sales, date_dim, customer
       where catalog_sales.cs_sold_date_sk = date_dim.d_date_sk
         and catalog_sales.cs_bill_customer_sk = customer.c_customer_sk
         and d_month_seq between 360 and 360 + 11)
      except
      (select distinct c_last_name, c_first_name, d_date
       from web_sales, date_dim, customer
       where web_sales.ws_sold_date_sk = date_dim.d_date_sk
         and web_sales.ws_bill_customer_sk = customer.c_customer_sk
         and d_month_seq between 360 and 360 + 11)) cool_cust
"""

Q[88] = """
select *
from (select count(*) h8_30_to_9
      from store_sales, household_demographics, time_dim, store
      where ss_sold_time_sk = time_dim.t_time_sk
        and ss_hdemo_sk = household_demographics.hd_demo_sk
        and ss_store_sk = s_store_sk and time_dim.t_hour = 8
        and time_dim.t_minute >= 30
        and ((household_demographics.hd_dep_count = 4
              and household_demographics.hd_vehicle_count <= 4 + 2)
          or (household_demographics.hd_dep_count = 2
              and household_demographics.hd_vehicle_count <= 2 + 2)
          or (household_demographics.hd_dep_count = 0
              and household_demographics.hd_vehicle_count <= 0 + 2))
        and store.s_store_name = 'ese') s1,
     (select count(*) h9_to_9_30
      from store_sales, household_demographics, time_dim, store
      where ss_sold_time_sk = time_dim.t_time_sk
        and ss_hdemo_sk = household_demographics.hd_demo_sk
        and ss_store_sk = s_store_sk and time_dim.t_hour = 9
        and time_dim.t_minute < 30
        and ((household_demographics.hd_dep_count = 4
              and household_demographics.hd_vehicle_count <= 4 + 2)
          or (household_demographics.hd_dep_count = 2
              and household_demographics.hd_vehicle_count <= 2 + 2)
          or (household_demographics.hd_dep_count = 0
              and household_demographics.hd_vehicle_count <= 0 + 2))
        and store.s_store_name = 'ese') s2,
     (select count(*) h9_30_to_10
      from store_sales, household_demographics, time_dim, store
      where ss_sold_time_sk = time_dim.t_time_sk
        and ss_hdemo_sk = household_demographics.hd_demo_sk
        and ss_store_sk = s_store_sk and time_dim.t_hour = 9
        and time_dim.t_minute >= 30
        and ((household_demographics.hd_dep_count = 4
              and household_demographics.hd_vehicle_count <= 4 + 2)
          or (household_demographics.hd_dep_count = 2
              and household_demographics.hd_vehicle_count <= 2 + 2)
          or (household_demographics.hd_dep_count = 0
              and household_demographics.hd_vehicle_count <= 0 + 2))
        and store.s_store_name = 'ese') s3,
     (select count(*) h10_to_10_30
      from store_sales, household_demographics, time_dim, store
      where ss_sold_time_sk = time_dim.t_time_sk
        and ss_hdemo_sk = household_demographics.hd_demo_sk
        and ss_store_sk = s_store_sk and time_dim.t_hour = 10
        and time_dim.t_minute < 30
        and ((household_demographics.hd_dep_count = 4
              and household_demographics.hd_vehicle_count <= 4 + 2)
          or (household_demographics.hd_dep_count = 2
              and household_demographics.hd_vehicle_count <= 2 + 2)
          or (household_demographics.hd_dep_count = 0
              and household_demographics.hd_vehicle_count <= 0 + 2))
        and store.s_store_name = 'ese') s4
"""

Q[89] = """
select *
from (select i_category, i_class, i_brand, s_store_name, s_company_name,
             d_moy, sum(ss_sales_price) sum_sales,
             avg(sum(ss_sales_price))
               over (partition by i_category, i_brand, s_store_name,
                     s_company_name) avg_monthly_sales
      from item, store_sales, date_dim, store
      where ss_item_sk = i_item_sk and ss_sold_date_sk = d_date_sk
        and ss_store_sk = s_store_sk and d_year in (1999)
        and ((i_category in ('Books', 'Electronics', 'Sports')
              and i_class in ('booksclass1', 'electronicsclass2',
                              'sportsclass3'))
          or (i_category in ('Men', 'Jewelry', 'Women')
              and i_class in ('menclass1', 'jewelryclass2', 'womenclass3')))
      group by i_category, i_class, i_brand, s_store_name, s_company_name,
               d_moy) tmp1
where case when avg_monthly_sales <> 0
           then abs(sum_sales - avg_monthly_sales) / avg_monthly_sales
           else null end > 0.1
order by sum_sales - avg_monthly_sales, s_store_name
limit 100
"""

Q[90] = """
select cast(amc as double) / cast(pmc as double) am_pm_ratio
from (select count(*) amc
      from web_sales, household_demographics, time_dim, web_page
      where ws_sold_time_sk = time_dim.t_time_sk
        and ws_ship_hdemo_sk = household_demographics.hd_demo_sk
        and ws_web_page_sk = web_page.wp_web_page_sk
        and time_dim.t_hour between 8 and 8 + 1
        and household_demographics.hd_dep_count = 6
        and web_page.wp_char_count between 5000 and 5200) at_,
     (select count(*) pmc
      from web_sales, household_demographics, time_dim, web_page
      where ws_sold_time_sk = time_dim.t_time_sk
        and ws_ship_hdemo_sk = household_demographics.hd_demo_sk
        and ws_web_page_sk = web_page.wp_web_page_sk
        and time_dim.t_hour between 19 and 19 + 1
        and household_demographics.hd_dep_count = 6
        and web_page.wp_char_count between 5000 and 5200) pt
order by am_pm_ratio
limit 100
"""

Q[91] = """
select cc_call_center_id call_center, cc_name call_center_name,
       cc_manager manager, sum(cr_net_loss) returns_loss
from call_center, catalog_returns, date_dim, customer,
     customer_address, customer_demographics, household_demographics
where cr_call_center_sk = cc_call_center_sk
  and cr_returned_date_sk = d_date_sk
  and cr_returning_customer_sk = c_customer_sk
  and cd_demo_sk = c_current_cdemo_sk and hd_demo_sk = c_current_hdemo_sk
  and ca_address_sk = c_current_addr_sk and d_year = 1998 and d_moy = 11
  and ((cd_marital_status = 'M' and cd_education_status = 'Unknown')
    or (cd_marital_status = 'W' and cd_education_status = 'Advanced Degree'))
  and hd_buy_potential like 'Unknown%' and ca_gmt_offset = -7.0
group by cc_call_center_id, cc_name, cc_manager, cd_marital_status,
         cd_education_status
order by returns_loss desc
"""

Q[92] = """
select sum(ws_ext_discount_amt) as excess_discount_amount
from web_sales, item, date_dim
where i_manufact_id = 350 and i_item_sk = ws_item_sk
  and d_date between date '2000-01-27' and date '2000-01-27' + interval '90' day
  and d_date_sk = ws_sold_date_sk
  and ws_ext_discount_amt > (
    select 1.3 * avg(ws_ext_discount_amt)
    from web_sales, date_dim
    where ws_item_sk = i_item_sk and d_date_sk = ws_sold_date_sk
      and d_date between date '2000-01-27'
                     and date '2000-01-27' + interval '90' day)
order by sum(ws_ext_discount_amt)
limit 100
"""

Q[93] = """
select ss_customer_sk, sum(act_sales) sumsales
from (select ss_item_sk, ss_ticket_number, ss_customer_sk,
             case when sr_return_quantity is not null
                  then (ss_quantity - sr_return_quantity) * ss_sales_price
                  else ss_quantity * ss_sales_price end act_sales
      from store_sales
           left outer join store_returns
             on (sr_item_sk = ss_item_sk
                 and sr_ticket_number = ss_ticket_number),
           reason
      where sr_reason_sk = r_reason_sk
        and r_reason_desc = 'Package was damaged') t
group by ss_customer_sk
order by sumsales, ss_customer_sk
limit 100
"""

Q[94] = """
select count(distinct ws_order_number) as order_count,
       sum(ws_ext_ship_cost) as total_shipping_cost,
       sum(ws_net_profit) as total_net_profit
from web_sales ws1, date_dim, customer_address, web_site
where d_date between date '1999-02-01' and date '1999-02-01' + interval '60' day
  and ws1.ws_ship_date_sk = d_date_sk
  and ws1.ws_ship_addr_sk = ca_address_sk and ca_state = 'IL'
  and ws1.ws_web_site_sk = web_site_sk and web_company_name = 'pri'
  and exists (select * from web_sales ws2
              where ws1.ws_order_number = ws2.ws_order_number
                and ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
  and not exists (select * from web_returns wr1
                  where ws1.ws_order_number = wr1.wr_order_number)
order by count(distinct ws_order_number)
limit 100
"""

Q[95] = """
with ws_wh as (
  select ws1.ws_order_number, ws1.ws_warehouse_sk wh1,
         ws2.ws_warehouse_sk wh2
  from web_sales ws1, web_sales ws2
  where ws1.ws_order_number = ws2.ws_order_number
    and ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
select count(distinct ws_order_number) as order_count,
       sum(ws_ext_ship_cost) as total_shipping_cost,
       sum(ws_net_profit) as total_net_profit
from web_sales ws1, date_dim, customer_address, web_site
where d_date between date '1999-02-01' and date '1999-02-01' + interval '60' day
  and ws1.ws_ship_date_sk = d_date_sk
  and ws1.ws_ship_addr_sk = ca_address_sk and ca_state = 'IL'
  and ws1.ws_web_site_sk = web_site_sk and web_company_name = 'pri'
  and ws1.ws_order_number in (select ws_order_number from ws_wh)
  and ws1.ws_order_number in (select wr_order_number
                              from web_returns, ws_wh
                              where wr_order_number = ws_wh.ws_order_number)
order by count(distinct ws_order_number)
limit 100
"""

Q[96] = """
select count(*) cnt
from store_sales, household_demographics, time_dim, store
where ss_sold_time_sk = time_dim.t_time_sk
  and ss_hdemo_sk = household_demographics.hd_demo_sk
  and ss_store_sk = s_store_sk and time_dim.t_hour = 20
  and time_dim.t_minute >= 30
  and household_demographics.hd_dep_count = 7
  and store.s_store_name = 'ese'
order by cnt
limit 100
"""

Q[97] = """
with ssci as (
  select ss_customer_sk customer_sk, ss_item_sk item_sk
  from store_sales, date_dim
  where ss_sold_date_sk = d_date_sk and d_month_seq between 360 and 360 + 11
  group by ss_customer_sk, ss_item_sk),
 csci as (
  select cs_bill_customer_sk customer_sk, cs_item_sk item_sk
  from catalog_sales, date_dim
  where cs_sold_date_sk = d_date_sk and d_month_seq between 360 and 360 + 11
  group by cs_bill_customer_sk, cs_item_sk)
select sum(case when ssci.customer_sk is not null
                 and csci.customer_sk is null then 1 else 0 end)
         store_only,
       sum(case when ssci.customer_sk is null
                 and csci.customer_sk is not null then 1 else 0 end)
         catalog_only,
       sum(case when ssci.customer_sk is not null
                 and csci.customer_sk is not null then 1 else 0 end)
         store_and_catalog
from ssci full outer join csci on (ssci.customer_sk = csci.customer_sk
                                   and ssci.item_sk = csci.item_sk)
limit 100
"""

Q[98] = """
select i_item_id, i_item_desc, i_category, i_class, i_current_price,
       sum(ss_ext_sales_price) as itemrevenue,
       sum(ss_ext_sales_price) * 100
         / sum(sum(ss_ext_sales_price)) over (partition by i_class)
         as revenueratio
from store_sales, item, date_dim
where ss_item_sk = i_item_sk
  and i_category in ('Sports', 'Books', 'Home')
  and ss_sold_date_sk = d_date_sk
  and d_date between date '1999-02-22' and date '1999-02-22' + interval '30' day
group by i_item_id, i_item_desc, i_category, i_class, i_current_price
order by i_category, i_class, i_item_id, i_item_desc, revenueratio
"""

Q[99] = """
select substr(w_warehouse_name, 1, 20), sm_type, cc_name,
       sum(case when cs_ship_date_sk - cs_sold_date_sk <= 30
                then 1 else 0 end) as days30,
       sum(case when cs_ship_date_sk - cs_sold_date_sk > 30
                 and cs_ship_date_sk - cs_sold_date_sk <= 60
                then 1 else 0 end) as days60,
       sum(case when cs_ship_date_sk - cs_sold_date_sk > 60
                 and cs_ship_date_sk - cs_sold_date_sk <= 90
                then 1 else 0 end) as days90,
       sum(case when cs_ship_date_sk - cs_sold_date_sk > 90
                 and cs_ship_date_sk - cs_sold_date_sk <= 120
                then 1 else 0 end) as days120,
       sum(case when cs_ship_date_sk - cs_sold_date_sk > 120
                then 1 else 0 end) as days_more_120
from catalog_sales, warehouse, ship_mode, call_center, date_dim
where d_month_seq between 360 and 360 + 11
  and cs_ship_date_sk = d_date_sk and cs_warehouse_sk = w_warehouse_sk
  and cs_ship_mode_sk = sm_ship_mode_sk and cs_call_center_sk = cc_call_center_sk
group by substr(w_warehouse_name, 1, 20), sm_type, cc_name
order by substr(w_warehouse_name, 1, 20), sm_type, cc_name
limit 100
"""
